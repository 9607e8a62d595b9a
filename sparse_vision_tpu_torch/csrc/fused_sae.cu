// Fused ReLU-SAE and Matryoshka-SAE kernels for Hopper (sm_90a): forward,
// backward and input gradient (dx).
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_sae.py and
// sparse_vision_tpu/ops/fused_matryoshka_sae.py:
//   sae_fwd_kernel<.., false>  <- fused_sae.py _fwd_kernel (:43), pallas_call :321
//   sae_bwd_kernel (one level) <- fused_sae.py _bwd_kernel (:96), pallas_call :391
//   sae_dx_kernel (one level)  <- fused_sae.py _dx_kernel (:168), pallas_call :422
//   sae_fwd_kernel<.., true>   <- fused_matryoshka_sae.py _fwd_kernel (:99), pallas_call :292
//   sae_bwd_kernel (P levels)  <- fused_matryoshka_sae.py _bwd_kernel (:155), pallas_call :371
//   sae_dx_kernel (P levels)   <- fused_matryoshka_sae.py _dx_kernel (:227), pallas_call :404
//
// What bounds them. At the training shape (T = 32,768 tokens, C = 256 channels,
// H = 16,384 latents) the forward is 4*T*C*H = 0.55 PFLOP, the backward
// 8*T*C*H = 1.1 PFLOP and dx 6*T*C*H = 0.82 PFLOP, against ~50 MB of operands
// (~150 MB with the Matryoshka prefix reconstructions): all are bounded by
// arithmetic, not by device memory, as long as the [T, H] latent matrix never
// reaches device memory (it would be 2 GB in f32 per pass). The kernels keep it
// on chip: the forward and dx hold one token tile's reconstruction (or dx) in
// registers while they sweep every latent tile, and the backward recomputes
// pre/post per token tile while it holds one latent tile's weight gradients in
// registers.
//
// Matryoshka (nested latent prefixes, boundaries b_0 < .. < b_{P-1} = H, each a
// multiple of kTH): the forward's accumulator passes through every prefix
// reconstruction on its way to the full one, so the forward writes a snapshot
// of it at the end of each prefix into prefix_recon [P, T, C]. Latent tile j
// of level q (b_{q-1} <= j*kTH < b_q) is read by every prefix p >= q, so its
// reconstruction cotangent is the suffix-weighted error S_q = sum_{p>=q} c_p
// err_p, computed by the caller; the backward and dx read S[level(j)] where
// the ReLU kernels read c_rec * err, and the ReLU op is the case P = 1.
//
// This first version computes with plain FMA loops (f32 accumulation) from
// shared memory, so it runs at the card's f32 SIMT rate, not its tensor-core
// rate: it is the correct reference layout for the wgmma/TMA version to come.
//
// Numerics follow the Pallas kernels' cast points exactly. The operand type T
// (float or bf16) is the compute dtype; x, W_enc, W_dec and the saved error
// arrive already cast to T. Inside:
//   x_cent = round_T(x - round_T(b_dec))              (a T-typed difference)
//   pre    = x_cent @ W_enc (f32 sum) + b_enc          (b_enc added in f32)
//   post   = max(pre, 0); the decode reads round_T(post)
//   recon  = sum_j round_T(post_j) @ W_dec_j + b_dec   (b_dec added in f32)
// Every cross-block sum leaves as a per-block partial that the caller reduces
// (activity counts, the L1 sum, the centring term of db_dec): no float atomics,
// so two runs on the same inputs give the same bits.
//
// Entry points use a plain C interface (pointers, sizes, stream) and return the
// cudaError_t of the launch; the Python wrappers (ops/fused_sae.py,
// ops/fused_matryoshka_sae.py) raise on a non-zero value. Supported shapes: C
// in {64, 128, 256}, T a multiple of kFwdTT, kBwdTT and kDxTT, H a multiple of
// kTH, at most kMaxLevels prefixes (can_fuse, can_fuse_matryoshka).

#include "sae_common.cuh"

namespace {

using svt::kThreads;
using svt::round_cd;
using svt::to_f;

constexpr int kFwdTT = 64;  // forward: tokens per block
constexpr int kBwdTT = 32;  // backward: tokens per inner step
constexpr int kDxTT = 32;   // dx: tokens per block
constexpr int kTH = 64;     // latents per tile (all kernels)
constexpr int kMaxLevels = 16;

// Prefix levels, passed by value: level p covers latents [end[p-1], end[p]),
// end[n-1] = H. The ReLU entry points pass one level. Every lookup runs over a
// fixed-size unrolled loop, so the array is indexed by constants only.
struct Levels {
  int n;
  int end[kMaxLevels];
};

// level of the latent tile that starts at h0
__device__ __forceinline__ int level_of(const Levels lv, int h0) {
  int q = 0;
#pragma unroll
  for (int p = 0; p < kMaxLevels - 1; ++p) q += (p < lv.n - 1 && h0 >= lv.end[p]);
  return q;
}

// true when a prefix ends at latent e
__device__ __forceinline__ bool ends_level(const Levels lv, int e) {
  bool r = false;
#pragma unroll
  for (int p = 0; p < kMaxLevels; ++p) r |= (p < lv.n && lv.end[p] == e);
  return r;
}

template <int C>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kFwdTT * (C + 1)      // xc_s
                          + C * kTH             // wenc_s
                          + kTH * C             // wdec_s
                          + kFwdTT * (kTH + 1)  // post_s
                          + kTH                 // benc_s
                          + kThreads / 32)      // red_s
         + sizeof(int) * (kTH + kFwdTT);        // colcnt_s, rowcnt_s
}

// Forward. One block owns kFwdTT tokens and sweeps all H latents in kTH tiles.
// Thread (ty, tx) holds recon rows ty*4 .. ty*4+3, columns tx + 16*j.
// kPrefix (Matryoshka): ``recon`` is prefix_recon [P, T, C]; at the end of each
// prefix level the block writes the accumulator (+ b_dec) into its level's
// slice, the last of which is the full reconstruction.
template <typename T, int C, bool kPrefix>
__global__ void __launch_bounds__(kThreads, 1)
sae_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
               const float* __restrict__ b_enc, const T* __restrict__ w_dec,
               const float* __restrict__ b_dec, float* __restrict__ recon,
               float* __restrict__ act_part, float* __restrict__ row_active,
               float* __restrict__ l1_part, int H, const Levels lv) {
  constexpr int TT = kFwdTT, TH = kTH;
  constexpr int XS = C + 1;   // padded row stride: rows 4 apart hit other banks
  constexpr int PS = TH + 1;
  constexpr int CJ = C / 16;  // recon columns per thread
  extern __shared__ float smem[];
  float* xc_s = smem;                 // [TT][XS]  centred input tile
  float* wenc_s = xc_s + TT * XS;     // [C][TH]   W_enc[:, h0:h0+TH]
  float* wdec_s = wenc_s + C * TH;    // [TH][C]   W_dec[h0:h0+TH, :]
  float* post_s = wdec_s + TH * C;    // [TT][PS]  round_T(post) of this tile
  float* benc_s = post_s + TT * PS;   // [TH]
  float* red_s = benc_s + TH;         // [warps]
  int* colcnt_s = reinterpret_cast<int*>(red_s + kThreads / 32);  // [TH]
  int* rowcnt_s = colcnt_s + TH;                                  // [TT]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long t0 = static_cast<long>(blockIdx.x) * TT;

  for (int i = tid; i < TT * C; i += kThreads) {
    const int r = i / C, k = i % C;
    xc_s[r * XS + k] =
        round_cd<T>(to_f(x[(t0 + r) * C + k]) - round_cd<T>(b_dec[k]));
  }
  for (int i = tid; i < TT; i += kThreads) rowcnt_s[i] = 0;

  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  int rowcnt[4] = {0, 0, 0, 0};
  float l1 = 0.f;
  auto store_recon = [&](float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = tx + 16 * j;
        out[(t0 + ty * 4 + i) * C + col] = acc[i][j] + b_dec[col];
      }
  };

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
        const float p = fmaxf(pre[i][j] + benc_s[tx + 16 * j], 0.f);
        l1 += p;
        const int on = p > 0.f;
        colc[j] += on;
        rowcnt[i] += on;
        post_s[(ty * 4 + i) * PS + tx + 16 * j] = round_cd<T>(p);
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
    if constexpr (kPrefix) {
      if (ends_level(lv, h0 + TH))  // the same for the whole block
        store_recon(recon + static_cast<long>(level_of(lv, h0)) * gridDim.x * TT * C);
    }
  }

  if constexpr (!kPrefix) store_recon(recon);
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(&rowcnt_s[ty * 4 + i], rowcnt[i]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) l1 += __shfl_down_sync(0xffffffffu, l1, off);
  if (tid % 32 == 0) red_s[tid / 32] = l1;
  __syncthreads();
  for (int i = tid; i < TT; i += kThreads)
    row_active[t0 + i] = static_cast<float>(rowcnt_s[i]);
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red_s[w];  // fixed order
    l1_part[blockIdx.x] = s;
  }
}

template <int C>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (C * kTH            // wenc_s
                          + C * kTH          // wdecT_s
                          + kBwdTT * (C + 1) // xc_s
                          + kBwdTT * (C + 1) // dr_s
                          + kBwdTT * kTH     // post_s
                          + kBwdTT * kTH     // dpre_s
                          + 16 * kTH         // red_s
                          + kTH              // benc_s
                          + kTH);            // bcd_s
}

// Backward. One block owns kTH latents and sweeps all T tokens in kBwdTT steps,
// recomputing pre/post for each step; dW_enc[:, tile] and dW_dec[tile, :] stay
// in registers (64 + 64 floats a thread at C = 256).
//   drecon = c_rec * err                (f32; the matmuls read round_T(drecon))
//   dpost  = round_T(drecon) @ W_dec^T + c_l1
//   dpre   = pre > 0 ? dpost : 0
//   dW_enc += xc^T @ round_T(dpre)      db_enc += sum_rows dpre (f32)
//   dW_dec += round_T(post)^T @ round_T(drecon)
// db_dec leaves as one partial row per block: -round_T(db_enc tile) @ W_enc^T,
// and block 0 adds the direct term sum_t drecon once.
// ``err`` is [P, T, C]: the block reads the slice of its tile's level
// (Matryoshka: S_q with c_rec = 1, so round_T(1 * S_q) = S_q exactly).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
sae_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
               const float* __restrict__ b_enc, const T* __restrict__ w_dec,
               const float* __restrict__ b_dec, const T* __restrict__ err,
               const float* __restrict__ coeffs, float* __restrict__ dw_enc,
               float* __restrict__ db_enc, float* __restrict__ dw_dec,
               float* __restrict__ db_dec_part, int n_tokens, int H, const Levels lv) {
  constexpr int TT = kBwdTT, TH = kTH;
  constexpr int XS = C + 1;
  constexpr int CI = C / 16;  // dW_enc rows (channels) per thread
  constexpr int CJ = C / 16;  // dW_dec columns (channels) per thread
  extern __shared__ float smem[];
  float* wenc_s = smem;               // [C][TH]
  float* wdecT_s = wenc_s + C * TH;   // [C][TH]  W_dec tile, transposed
  float* xc_s = wdecT_s + C * TH;     // [TT][XS]
  float* dr_s = xc_s + TT * XS;       // [TT][XS] round_T(drecon)
  float* post_s = dr_s + TT * XS;     // [TT][TH] round_T(post)
  float* dpre_s = post_s + TT * TH;   // [TT][TH] round_T(dpre)
  float* red_s = dpre_s + TT * TH;    // [16][TH]
  float* benc_s = red_s + 16 * TH;    // [TH]
  float* bcd_s = benc_s + TH;         // [TH] round_T(db_enc)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h0 = blockIdx.x * TH;
  const float c_rec = coeffs[0], c_l1 = coeffs[1];
  err += static_cast<long>(level_of(lv, h0)) * n_tokens * C;

  for (int i = tid; i < C * TH; i += kThreads) {
    const int k = i / TH, l = i % TH;
    wenc_s[i] = to_f(w_enc[static_cast<long>(k) * H + h0 + l]);
  }
  for (int i = tid; i < TH * C; i += kThreads) {
    const int l = i / C, k = i % C;
    wdecT_s[k * TH + l] = to_f(w_dec[static_cast<long>(h0) * C + i]);
  }
  for (int i = tid; i < TH; i += kThreads) benc_s[i] = b_enc[h0 + i];

  float gwe[CI][4], gwd[4][CJ], gbe[4] = {0.f, 0.f, 0.f, 0.f};
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
      dr_s[r * XS + k] = round_cd<T>(c_rec * to_f(err[g]));
    }
    if (blockIdx.x == 0 && tid < C)
      for (int r = 0; r < TT; ++r)
        direct += c_rec * to_f(err[static_cast<long>(t0 + r) * C + tid]);
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
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 2 + i, col = tx + 16 * j;
        const float p = pre[i][j] + benc_s[col];
        const float dp = p > 0.f ? dpo[i][j] + c_l1 : 0.f;
        gbe[j] += dp;
        post_s[row * TH + col] = round_cd<T>(fmaxf(p, 0.f));
        dpre_s[row * TH + col] = round_cd<T>(dp);
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
#pragma unroll
  for (int j = 0; j < 4; ++j) red_s[ty * TH + tx + 16 * j] = gbe[j];
  __syncthreads();
  for (int l = tid; l < TH; l += kThreads) {
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += red_s[g * TH + l];  // fixed order
    db_enc[h0 + l] = s;
    bcd_s[l] = round_cd<T>(s);
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
              const Levels lv) {
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
    const int q = level_of(lv, h0);
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

// Levels of the prefix boundaries ``bounds`` (host array of n latent counts);
// false unless 1 <= n <= kMaxLevels and the counts are strictly increasing
// multiples of kTH ending at H.
bool make_levels(const int* bounds, int n, int H, Levels* lv) {
  if (n < 1 || n > kMaxLevels || bounds[n - 1] != H) return false;
  *lv = Levels{};
  lv->n = n;
  for (int p = 0; p < n; ++p) {
    if (bounds[p] <= (p ? bounds[p - 1] : 0) || bounds[p] % kTH) return false;
    lv->end[p] = bounds[p];
  }
  return true;
}

Levels one_level(int H) {
  Levels lv{};
  lv.n = 1;
  lv.end[0] = H;
  return lv;
}

template <bool kPrefix>
cudaError_t launch_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                const void* w_dec, const float* b_dec, float* recon, float* act_part,
                float* row_active, float* l1_part, int n_tokens, int C, int H,
                const Levels& lv, cudaStream_t stream) {
  if (n_tokens <= 0 || H <= 0 || n_tokens % kFwdTT || H % kTH) return cudaErrorInvalidValue;
  return svt::dispatch(bf16, C, [&](auto t, auto c) {
    using T = decltype(t);
    constexpr int CC = decltype(c)::value;
    return svt::launch(sae_fwd_kernel<T, CC, kPrefix>, n_tokens / kFwdTT,
                       fwd_smem_bytes<CC>(), stream, static_cast<const T*>(x),
                       static_cast<const T*>(w_enc), b_enc, static_cast<const T*>(w_dec),
                       b_dec, recon, act_part, row_active, l1_part, H, lv);
  });
}

cudaError_t launch_bwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                const void* w_dec, const float* b_dec, const void* err, const float* coeffs,
                float* dw_enc, float* db_enc, float* dw_dec, float* db_dec_part,
                int n_tokens, int C, int H, const Levels& lv, cudaStream_t stream) {
  if (n_tokens <= 0 || H <= 0 || n_tokens % kBwdTT || H % kTH) return cudaErrorInvalidValue;
  return svt::dispatch(bf16, C, [&](auto t, auto c) {
    using T = decltype(t);
    constexpr int CC = decltype(c)::value;
    return svt::launch(sae_bwd_kernel<T, CC>, H / kTH, bwd_smem_bytes<CC>(), stream,
                       static_cast<const T*>(x), static_cast<const T*>(w_enc), b_enc,
                       static_cast<const T*>(w_dec), b_dec, static_cast<const T*>(err),
                       coeffs, dw_enc, db_enc, dw_dec, db_dec_part, n_tokens, H, lv);
  });
}

cudaError_t launch_dx(int bf16, const void* x, const void* w_enc, const float* b_enc,
               const void* w_dec, const float* b_dec, const void* err, const float* coeffs,
               float* out, int n_tokens, int C, int H, const Levels& lv,
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
// float. coeffs is a 2-float device array (c_rec, c_l1).
// ---------------------------------------------------------------------------

// act_part is [n_tokens / 64, H] (per-token-tile activity counts), l1_part is
// [n_tokens / 64].
extern "C" int svt_sae_fwd(int bf16, const void* x, const void* w_enc,
                           const float* b_enc, const void* w_dec, const float* b_dec,
                           float* recon, float* act_part, float* row_active,
                           float* l1_part, int n_tokens, int C, int H,
                           cudaStream_t stream) {
  return launch_fwd<false>(bf16, x, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                           row_active, l1_part, n_tokens, C, H, one_level(H), stream);
}

// err is the [T, C] residual recon - x; db_dec_part is [H / 64, C].
extern "C" int svt_sae_bwd(int bf16, const void* x, const void* w_enc,
                           const float* b_enc, const void* w_dec, const float* b_dec,
                           const void* err, const float* coeffs, float* dw_enc,
                           float* db_enc, float* dw_dec, float* db_dec_part,
                           int n_tokens, int C, int H, cudaStream_t stream) {
  return launch_bwd(bf16, x, w_enc, b_enc, w_dec, b_dec, err, coeffs, dw_enc, db_enc,
                    dw_dec, db_dec_part, n_tokens, C, H, one_level(H), stream);
}

// dx is [T, C] f32.
extern "C" int svt_sae_dx(int bf16, const void* x, const void* w_enc, const float* b_enc,
                          const void* w_dec, const float* b_dec, const void* err,
                          const float* coeffs, float* out, int n_tokens, int C, int H,
                          cudaStream_t stream) {
  return launch_dx(bf16, x, w_enc, b_enc, w_dec, b_dec, err, coeffs, out, n_tokens, C, H,
                   one_level(H), stream);
}

// ---------------------------------------------------------------------------
// Matryoshka SAE (ops/fused_matryoshka_sae.py): ``bounds`` is a host array of
// the n_levels prefix latent counts. s is the [P, T, C] suffix-weighted error
// and coeffs = (1, c_l1).
// ---------------------------------------------------------------------------

// prefix_recon is [P, T, C] f32; act_part and l1_part as for svt_sae_fwd.
extern "C" int svt_matryoshka_fwd(int bf16, const void* x, const void* w_enc,
                                  const float* b_enc, const void* w_dec,
                                  const float* b_dec, float* prefix_recon, float* act_part,
                                  float* row_active, float* l1_part, int n_tokens, int C,
                                  int H, const int* bounds, int n_levels,
                                  cudaStream_t stream) {
  Levels lv;
  if (!make_levels(bounds, n_levels, H, &lv)) return cudaErrorInvalidValue;
  return launch_fwd<true>(bf16, x, w_enc, b_enc, w_dec, b_dec, prefix_recon, act_part,
                          row_active, l1_part, n_tokens, C, H, lv, stream);
}

extern "C" int svt_matryoshka_bwd(int bf16, const void* x, const void* w_enc,
                                  const float* b_enc, const void* w_dec,
                                  const float* b_dec, const void* s, const float* coeffs,
                                  float* dw_enc, float* db_enc, float* dw_dec,
                                  float* db_dec_part, int n_tokens, int C, int H,
                                  const int* bounds, int n_levels, cudaStream_t stream) {
  Levels lv;
  if (!make_levels(bounds, n_levels, H, &lv)) return cudaErrorInvalidValue;
  return launch_bwd(bf16, x, w_enc, b_enc, w_dec, b_dec, s, coeffs, dw_enc, db_enc, dw_dec,
                    db_dec_part, n_tokens, C, H, lv, stream);
}

extern "C" int svt_matryoshka_dx(int bf16, const void* x, const void* w_enc,
                                 const float* b_enc, const void* w_dec, const float* b_dec,
                                 const void* s, const float* coeffs, float* out,
                                 int n_tokens, int C, int H, const int* bounds,
                                 int n_levels, cudaStream_t stream) {
  Levels lv;
  if (!make_levels(bounds, n_levels, H, &lv)) return cudaErrorInvalidValue;
  return launch_dx(bf16, x, w_enc, b_enc, w_dec, b_dec, s, coeffs, out, n_tokens, C, H, lv,
                   stream);
}
