// Fused transcoder and crosscoder kernels for Hopper (sm_90a): forward and
// backward of a ReLU dictionary that reads one space and decodes into another.
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_transcoder.py
// and sparse_vision_tpu/ops/fused_crosscoder.py:
//   coder_fwd_kernel <- fused_transcoder.py _fwd_kernel (:41), pallas_call :227
//                       fused_crosscoder.py _fwd_kernel (:68), pallas_call :238
//   coder_bwd_kernel <- fused_transcoder.py _bwd_kernel (:91), pallas_call :264
//                       fused_crosscoder.py _bwd_kernel (:109), pallas_call :274
// The two ops differ only in their L1 statistic, so one body serves both: the
// forward always emits per-latent sums of post (zsum partials; the transcoder's
// scalar sum of post is their total) and the backward always takes a per-latent
// L1 cotangent ct [H] (the transcoder passes its scalar c_l1 broadcast). The
// crosscoder runs in its concatenated, scaled space (ops/fused_crosscoder.py).
//
// Shapes: x [T, Cin], W_enc [Cin, H], W_dec [H, Cout], recon and err [T, Cout].
// No input centring: b_dec lives in the output space. Cin and Cout are any
// positive widths (transcoder 256 -> 480, crosscoder 2,896 -> 2,896 =
// 16 * 181): every channel chunk is loaded with a guard that zero-fills past the
// width, and stores past it are skipped, so no padding is needed.
//
// What bounds them. At the transcoder's training shape (T = 32,768, H = 16,384)
// the forward is 2*T*H*(Cin+Cout) = 0.79 PFLOP and the backward twice that; at
// the crosscoder's (T = 16,384, H = 8,192, Cin = Cout = 2,896) 1.55 and 3.1
// PFLOP. Operands are ~0.2 GB: both are bounded by arithmetic as long as the
// [T, H] latent matrix never reaches device memory. This first version computes
// with plain FMA loops (f32 accumulation) from shared memory, the card's f32
// SIMT rate; wgmma and TMA come later.
//
// Widths too large for the on-chip accumulators of csrc/fused_sae.cu. There a
// forward block keeps recon [64, C] and a backward block dW_enc [C, 64] and
// dW_dec [64, C] in registers for the whole sweep; at Cout = 2,896 that is
// 0.74 MB and 1.48 MB. Here each output lives in device memory and is updated
// read-modify-write by its only owner (one thread of one block), in a fixed
// order, so results stay bitwise repeatable and no atomics are needed. To keep
// that traffic down, the forward computes post for 128 latents at a time into
// shared memory before it sweeps the output columns once, and the backward
// computes post and dpre for 128 tokens at a time before it sweeps the input
// and output channels once (phases A, B, C below).
//
// Numerics follow the Pallas kernels' cast points. The operand type T (float
// or bf16) is the compute dtype; x, W_enc, W_dec and err arrive already cast:
//   pre    = x @ W_enc (f32 sum) + b_enc     post = max(pre, 0)
//   recon  = sum_j round_T(post_j) @ W_dec_j + b_dec    (f32; b_dec in f32)
//   drecon = c_rec * err (f32; the products read round_T(drecon))
//   dpost  = round_T(drecon) @ W_dec^T + ct     dpre = pre > 0 ? dpost : 0
//   dW_enc = x^T @ round_T(dpre)    db_enc = sum_t dpre
//   dW_dec = round_T(post)^T @ round_T(drecon)    db_dec = sum_t drecon
// Cross-block sums (activity counts, zsum) leave as per-block partials that the
// caller reduces; db_dec, which does not depend on the latents, is summed by
// block 0 alone, in two partials over alternate token rows.
//
// Entry points use a plain C interface (pointers, sizes, stream) and return the
// cudaError_t of the launch; the Python wrappers (ops/fused_transcoder.py,
// ops/fused_crosscoder.py) raise on a non-zero value. Supported shapes: T a
// multiple of kBwdTB (and so of kFwdTT), H a multiple of kFwdLG (and so of
// kBwdTH) (can_fuse).

#include "sae_common.cuh"

namespace {

using svt::kThreads;
using svt::round_cd;
using svt::to_f;

constexpr int kKC = 32;      // channels per chunk of the encode and dpost contractions
constexpr int kFwdTT = 64;   // forward: tokens per block
constexpr int kFwdLG = 128;  // forward: latents per group (post held in shared memory)
constexpr int kFwdNC = 128;  // forward: output columns per decode chunk
constexpr int kFwdLS = 64;   // forward: latents per W_dec sub-tile of a decode chunk
constexpr int kBwdTH = 64;   // backward: latents per block
constexpr int kBwdTB = 128;  // backward: tokens per step (post and dpre held in shared memory)
constexpr int kBwdKB = 128;  // backward: dW_enc rows per chunk
constexpr int kBwdNC = 128;  // backward: dW_dec columns per chunk

constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kFwdTT * (kKC + 1)       // xs
                          + kKC * kFwdLG           // ws
                          + kFwdTT * (kFwdLG + 1)  // post_s
                          + kFwdLS * kFwdNC        // wd_s
                          + kFwdLG                 // benc_s
                          + 16 * kFwdLG)           // zred_s
         + sizeof(int) * (16 * kFwdLG + kFwdTT);   // ccnt_s, rcnt_s
}

// Forward. One block owns kFwdTT tokens and sweeps the latents in groups of
// kFwdLG. Per group: pre [64, 128] by a K-loop over the input channels (rows
// ty*4+i, columns tx+16*j), post into shared memory with the group's
// statistics, then a sweep of the output columns in chunks of kFwdNC: acc
// [64, 128] (rows ty*4+i, columns tx+16*j) over the group's latents, added
// into recon in device memory by the thread that owns those elements.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
coder_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
                 const float* __restrict__ b_enc, const T* __restrict__ w_dec,
                 const float* __restrict__ b_dec, float* __restrict__ recon,
                 float* __restrict__ act_part, float* __restrict__ row_active,
                 float* __restrict__ zsum_part, int Cin, int Cout, int H) {
  constexpr int TT = kFwdTT, LG = kFwdLG, KC = kKC, NC = kFwdNC, LS = kFwdLS;
  constexpr int XS = KC + 1;  // padded row strides: rows 4 apart hit other banks
  constexpr int PS = LG + 1;
  extern __shared__ float smem[];
  float* xs = smem;                  // [TT][XS]  x[:, k0:k0+KC]
  float* ws = xs + TT * XS;          // [KC][LG]  W_enc[k0:k0+KC, g0:g0+LG]
  float* post_s = ws + KC * LG;      // [TT][PS]  round_T(post) of the group
  float* wd_s = post_s + TT * PS;    // [LS][NC]  W_dec[g0+l0 : +LS, c0 : +NC]
  float* benc_s = wd_s + LS * NC;    // [LG]
  float* zred_s = benc_s + LG;       // [16][LG]  per-thread-row partials of zsum
  int* ccnt_s = reinterpret_cast<int*>(zred_s + 16 * LG);  // [16][LG]
  int* rcnt_s = ccnt_s + 16 * LG;                          // [TT]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long t0 = static_cast<long>(blockIdx.x) * TT;

  for (int i = tid; i < TT; i += kThreads) rcnt_s[i] = 0;
  int rowc[4] = {0, 0, 0, 0};

  for (int g0 = 0; g0 < H; g0 += LG) {
    // encode: pre[TT, LG] = x tile @ W_enc[:, g0:g0+LG]
    float pre[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) pre[i][j] = 0.f;
    for (int k0 = 0; k0 < Cin; k0 += KC) {
      __syncthreads();  // the previous chunk (or group) is done with xs, ws, benc_s
      for (int i = tid; i < TT * KC; i += kThreads) {
        const int r = i / KC, k = k0 + i % KC;
        xs[r * XS + i % KC] = k < Cin ? to_f(x[(t0 + r) * Cin + k]) : 0.f;
      }
      for (int i = tid; i < KC * LG; i += kThreads) {
        const int k = k0 + i / LG, l = i % LG;
        ws[i] = k < Cin ? to_f(w_enc[static_cast<long>(k) * H + g0 + l]) : 0.f;
      }
      if (k0 == 0)
        for (int i = tid; i < LG; i += kThreads) benc_s[i] = b_enc[g0 + i];
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty * 4 + i) * XS + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ws[kk * LG + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) pre[i][j] = fmaf(a[i], b[j], pre[i][j]);
      }
    }

    // post, and the group's statistics: activity counts and zsum per latent
    // (over this block's tokens), activity per token (over all latents)
    int colc[8];
    float zs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      colc[j] = 0;
      zs[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        const float p = fmaxf(pre[i][j] + benc_s[col], 0.f);
        const int on = p > 0.f;
        colc[j] += on;
        zs[j] += p;
        rowc[i] += on;
        post_s[(ty * 4 + i) * PS + col] = round_cd<T>(p);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      zred_s[ty * LG + tx + 16 * j] = zs[j];
      ccnt_s[ty * LG + tx + 16 * j] = colc[j];
    }
    __syncthreads();
    for (int l = tid; l < LG; l += kThreads) {
      float z = 0.f;
      int c = 0;
      for (int g = 0; g < 16; ++g) {  // fixed order
        z += zred_s[g * LG + l];
        c += ccnt_s[g * LG + l];
      }
      const long o = static_cast<long>(blockIdx.x) * H + g0 + l;
      act_part[o] = static_cast<float>(c);
      zsum_part[o] = z;
    }

    // decode: recon[:, c0:c0+NC] += round_T(post) @ W_dec[g0:g0+LG, c0:c0+NC]
    for (int c0 = 0; c0 < Cout; c0 += NC) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int l0 = 0; l0 < LG; l0 += LS) {
        __syncthreads();  // post_s is complete; the previous sub-tile is done with wd_s
        for (int i = tid; i < LS * NC; i += kThreads) {
          const int l = i / NC, col = c0 + i % NC;
          wd_s[i] = col < Cout ? to_f(w_dec[static_cast<long>(g0 + l0 + l) * Cout + col]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int l = 0; l < LS; ++l) {
          float a[4], b[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = post_s[(ty * 4 + i) * PS + l0 + l];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = wd_s[l * NC + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col < Cout) {
            const long o = (t0 + ty * 4 + i) * Cout + col;
            recon[o] = (g0 == 0 ? b_dec[col] : recon[o]) + acc[i][j];
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(&rcnt_s[ty * 4 + i], rowc[i]);  // integer: exact
  __syncthreads();
  for (int i = tid; i < TT; i += kThreads) row_active[t0 + i] = static_cast<float>(rcnt_s[i]);
}

constexpr int kBufFloats = kBwdTB * (kBwdKB + 1);  // the larger of the three phases' buffers
static_assert(kBufFloats >= kBwdTB * (kKC + 1) + kKC * (kBwdTH + 1), "phase A buffer");
static_assert(kBufFloats >= kBwdTB * kBwdNC, "phase C buffer");
static_assert(kThreads == 2 * kBwdNC, "phase C: two row parities per column");

constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (2 * kBwdTB * kBwdTH  // post_s, dpre_s
                          + kBufFloats         // buf
                          + 2 * kBwdTH         // benc_s, ct_s
                          + 16 * kBwdTH);      // red_s
}

// Backward. One block owns kBwdTH latents and sweeps all tokens in steps of
// kBwdTB. Per step:
//   A. pre and dpost [128, 64] (rows ty*8+i, columns tx+16*j) by K-loops over
//      the input and the output channels; round_T(post) and round_T(dpre) into
//      shared memory; db_enc accumulates in registers.
//   B. for each chunk of kBwdKB input channels: g [128, 64] = x chunk^T @ dpre
//      (rows ty*8+i, columns tx+16*j), added into dW_enc in device memory.
//   C. for each chunk of kBwdNC output channels: g [64, 128] = post^T @
//      round_T(drecon chunk) (rows ty*4+i, columns tx+16*j), added into dW_dec.
// The first step writes the gradients, later steps add to them: each element
// has one owning thread, which updates it in token order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
coder_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
                 const float* __restrict__ b_enc, const T* __restrict__ w_dec,
                 const T* __restrict__ err, const float* __restrict__ coeffs,
                 const float* __restrict__ ct, float* __restrict__ dw_enc,
                 float* __restrict__ db_enc, float* __restrict__ dw_dec,
                 float* __restrict__ db_dec_part, int n_tokens, int Cin, int Cout, int H) {
  constexpr int TH = kBwdTH, TB = kBwdTB, KC = kKC, KB = kBwdKB, NC = kBwdNC;
  constexpr int XS = KC + 1, WS = TH + 1, BS = KB + 1;
  extern __shared__ float smem[];
  float* post_s = smem;              // [TB][TH]  round_T(post)
  float* dpre_s = post_s + TB * TH;  // [TB][TH]  round_T(dpre)
  float* buf = dpre_s + TB * TH;     // per phase, below
  float* as_ = buf;                  // A: [TB][XS] x or round_T(drecon) chunk
  float* bs_ = buf + TB * XS;        // A: [KC][WS] W_enc chunk, or W_dec chunk transposed
  float* xb = buf;                   // B: [TB][BS] x chunk
  float* drb = buf;                  // C: [TB][NC] round_T(drecon) chunk
  float* benc_s = buf + kBufFloats;  // [TH]
  float* ct_s = benc_s + TH;         // [TH]
  float* red_s = ct_s + TH;          // [16][TH]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h0 = blockIdx.x * TH;
  const float c_rec = coeffs[0];

  for (int i = tid; i < TH; i += kThreads) {
    benc_s[i] = b_enc[h0 + i];
    ct_s[i] = ct[h0 + i];
  }
  float gbe[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t0 = 0; t0 < n_tokens; t0 += TB) {
    const bool first = t0 == 0;

    // A. pre = x @ W_enc tile + b_enc, then dpost = round_T(drecon) @ W_dec tile^T
    float pre[8][4], acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Cin; k0 += KC) {
      __syncthreads();  // the previous users of buf are done
      for (int i = tid; i < TB * KC; i += kThreads) {
        const int r = i / KC, k = k0 + i % KC;
        as_[r * XS + i % KC] =
            k < Cin ? to_f(x[static_cast<long>(t0 + r) * Cin + k]) : 0.f;
      }
      for (int i = tid; i < KC * TH; i += kThreads) {
        const int kk = i / TH, l = i % TH, k = k0 + kk;
        bs_[kk * WS + l] = k < Cin ? to_f(w_enc[static_cast<long>(k) * H + h0 + l]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = as_[(ty * 8 + i) * XS + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs_[kk * WS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pre[i][j] = acc[i][j] + benc_s[tx + 16 * j];
        acc[i][j] = 0.f;
      }
    for (int k0 = 0; k0 < Cout; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < TB * KC; i += kThreads) {
        const int r = i / KC, k = k0 + i % KC;
        as_[r * XS + i % KC] =
            k < Cout ? round_cd<T>(c_rec * to_f(err[static_cast<long>(t0 + r) * Cout + k]))
                     : 0.f;
      }
      for (int i = tid; i < TH * KC; i += kThreads) {
        const int l = i / KC, kk = i % KC, k = k0 + kk;
        bs_[kk * WS + l] =
            k < Cout ? to_f(w_dec[static_cast<long>(h0 + l) * Cout + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = as_[(ty * 8 + i) * XS + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs_[kk * WS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 8 + i, col = tx + 16 * j;
        const float p = pre[i][j];
        const float dp = p > 0.f ? acc[i][j] + ct_s[col] : 0.f;
        gbe[j] += dp;
        post_s[row * TH + col] = round_cd<T>(fmaxf(p, 0.f));
        dpre_s[row * TH + col] = round_cd<T>(dp);
      }

    // B. dW_enc[k0:k0+KB, tile] += x[:, k0:k0+KB]^T @ round_T(dpre)
    for (int k0 = 0; k0 < Cin; k0 += KB) {
      __syncthreads();  // post_s and dpre_s are complete; buf is free
      for (int i = tid; i < TB * KB; i += kThreads) {
        const int r = i / KB, k = k0 + i % KB;
        xb[r * BS + i % KB] = k < Cin ? to_f(x[static_cast<long>(t0 + r) * Cin + k]) : 0.f;
      }
      __syncthreads();
      float g[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < TB; ++r) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = xb[r * BS + ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = dpre_s[r * TH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + ty * 8 + i;
        if (k < Cin) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long o = static_cast<long>(k) * H + h0 + tx + 16 * j;
            dw_enc[o] = first ? g[i][j] : dw_enc[o] + g[i][j];
          }
        }
      }
    }

    // C. dW_dec[tile, c0:c0+NC] += round_T(post)^T @ round_T(drecon[:, c0:c0+NC])
    for (int c0 = 0; c0 < Cout; c0 += NC) {
      __syncthreads();  // the previous chunk is done with buf
      {
        // thread tid loads column c of every (kThreads / NC)-th row from r0;
        // block 0 also sums those rows' f32 drecon into db_dec_part[r0, :]
        const int c = tid % NC, r0 = tid / NC, k = c0 + c;
        float s = 0.f;
        for (int r = r0; r < TB; r += kThreads / NC) {
          const float d =
              k < Cout ? c_rec * to_f(err[static_cast<long>(t0 + r) * Cout + k]) : 0.f;
          s += d;
          drb[r * NC + c] = round_cd<T>(d);
        }
        if (blockIdx.x == 0 && k < Cout) {
          const long o = static_cast<long>(r0) * Cout + k;
          db_dec_part[o] = first ? s : db_dec_part[o] + s;
        }
      }
      __syncthreads();
      float g[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < TB; ++r) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = post_s[r * TH + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = drb[r * NC + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = c0 + tx + 16 * j;
          if (k < Cout) {
            const long o = static_cast<long>(h0 + ty * 4 + i) * Cout + k;
            dw_dec[o] = first ? g[i][j] : dw_dec[o] + g[i][j];
          }
        }
    }
  }

  // db_enc: the per-thread column sums, reduced over the 16 thread rows in order
#pragma unroll
  for (int j = 0; j < 4; ++j) red_s[ty * TH + tx + 16 * j] = gbe[j];
  __syncthreads();
  for (int l = tid; l < TH; l += kThreads) {
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += red_s[g * TH + l];
    db_enc[h0 + l] = s;
  }
}

bool bad_shape(int n_tokens, int c_in, int c_out, int H) {
  return n_tokens <= 0 || c_in <= 0 || c_out <= 0 || H <= 0 || n_tokens % kBwdTB ||
         H % kFwdLG;
}

}  // namespace

// act_part and zsum_part are [n_tokens / 64, H] (per-token-tile partials),
// recon [n_tokens, c_out] f32, row_active [n_tokens]. bf16 != 0 selects
// __nv_bfloat16 operands, else float.
extern "C" int svt_coder_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                             const void* w_dec, const float* b_dec, float* recon,
                             float* act_part, float* row_active, float* zsum_part,
                             int n_tokens, int c_in, int c_out, int H, cudaStream_t stream) {
  if (bad_shape(n_tokens, c_in, c_out, H)) return cudaErrorInvalidValue;
  auto go = [&](auto t) {
    using T = decltype(t);
    return svt::launch(coder_fwd_kernel<T>, n_tokens / kFwdTT, fwd_smem_bytes(), stream,
                       static_cast<const T*>(x), static_cast<const T*>(w_enc), b_enc,
                       static_cast<const T*>(w_dec), b_dec, recon, act_part, row_active,
                       zsum_part, c_in, c_out, H);
  };
  return bf16 ? go(__nv_bfloat16{}) : go(float{});
}

// err is [n_tokens, c_out] in the operand type; coeffs is a 1-float device array
// (c_rec), ct the [H] per-latent L1 cotangent. Outputs f32: dw_enc [c_in, H],
// db_enc [H], dw_dec [H, c_out], db_dec_part [2, c_out] (two partial sums over
// alternate token rows; db_dec is their sum).
extern "C" int svt_coder_bwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                             const void* w_dec, const void* err, const float* coeffs,
                             const float* ct, float* dw_enc, float* db_enc, float* dw_dec,
                             float* db_dec_part, int n_tokens, int c_in, int c_out, int H,
                             cudaStream_t stream) {
  if (bad_shape(n_tokens, c_in, c_out, H)) return cudaErrorInvalidValue;
  auto go = [&](auto t) {
    using T = decltype(t);
    return svt::launch(coder_bwd_kernel<T>, H / kBwdTH, bwd_smem_bytes(), stream,
                       static_cast<const T*>(x), static_cast<const T*>(w_enc), b_enc,
                       static_cast<const T*>(w_dec), static_cast<const T*>(err), coeffs, ct,
                       dw_enc, db_enc, dw_dec, db_dec_part, n_tokens, c_in, c_out, H);
  };
  return bf16 ? go(__nv_bfloat16{}) : go(float{});
}
