// Fused Gated-SAE training kernels for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of sparse_vision_tpu/ops/fused_gated_sae.py:
//   svt_gated_fwd <- _fwd_kernel (:42), launched by pallas_call :234
//   svt_gated_bwd <- _bwd_kernel (:98), launched by pallas_call :292
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
//   backward: coder_bwd_tc<true, Act::Gated> after scale_err_kernel twice
//     (round_bf16(c_rec * err_rec) with the direct db_dec rows, and
//     round_bf16(c_aux * err_via), which gives b_dec no gradient), into one
//     [2, T, C] workspace whose second half the body's third phase-A product
//     reads.
//
// In f32 (the check path) both run the SIMT bodies below (namespace simt,
// instantiated for float only), C in {64, 128, 256}. The forward holds a token
// tile's recon AND via_gate in registers while it sweeps every latent tile;
// the backward holds a latent tile's weight gradients in registers while it
// sweeps every token, recomputing the gate product per token step. Plain FMA
// loops from shared memory (the f32 SIMT rate).
//
// SIMT tiles. Two [tokens, C] accumulators a thread would need 128 registers at
// 64 tokens, so the forward takes 32 tokens a block (64 accumulator floats a
// thread, as in the ReLU forward). The backward keeps three [tokens, C] operand
// tiles (x_cent, drecon, dvia) beside the two weight tiles, which fits shared
// memory at 16 tokens a step; its per-latent sums (db_gate, db_mag,
// sum d_premag*g, sum dg) live in shared-memory slots that only their thread
// touches, not in registers.
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
// Supported shapes (ops/fused_gated_sae.py fwd_takes, bwd_takes): in bf16
// coder.cuh's rule; in f32 the SIMT bodies' C in {64, 128, 256}, T a multiple
// of kFwdTT and kBwdTT, H of kTH.

#include "coder.cuh"

namespace {
namespace simt {  // the SIMT bodies: the f32 forward and backward (the check path)

constexpr int kFwdTT = 32;  // forward: tokens per block
constexpr int kBwdTT = 16;  // backward: tokens per inner step
constexpr int kTH = 64;     // latents per tile (both kernels)

// the detached Heaviside of the gate: 1 / 0.5 / 0 at > 0 / == 0 / < 0
__device__ __forceinline__ float gate_of(float pre_gate) {
  return pre_gate > 0.f ? 1.f : (pre_gate == 0.f ? 0.5f : 0.f);
}

template <int C>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kFwdTT * (C + 1)          // xc_s
                          + C * kTH                 // wg_s
                          + kTH * C                 // wd_s
                          + 2 * kFwdTT * (kTH + 1)  // enc_s, pi_s
                          + 3 * kTH                 // bg_s, bm_s, er_s
                          + kThreads)               // red_s
         + sizeof(int) * (kTH + kFwdTT);            // colcnt_s, rowcnt_s
}

// Forward. One block owns kFwdTT tokens and sweeps all H latents in kTH tiles.
// Thread (ty, tx) holds recon and via rows ty*2, ty*2+1, columns tx + 16*j.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
gated_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_gate,
                 const float* __restrict__ b_gate, const float* __restrict__ b_mag,
                 const float* __restrict__ er, const T* __restrict__ w_dec,
                 const float* __restrict__ b_dec, float* __restrict__ recon,
                 float* __restrict__ via, float* __restrict__ act_part,
                 float* __restrict__ row_active, float* __restrict__ l1_part, int H) {
  constexpr int TT = kFwdTT, TH = kTH;
  constexpr int XS = C + 1;  // padded row stride
  constexpr int PS = TH + 1;
  constexpr int CJ = C / 16;  // recon/via columns per thread
  extern __shared__ float smem[];
  float* xc_s = smem;              // [TT][XS]  centred input tile
  float* wg_s = xc_s + TT * XS;    // [C][TH]   W_gate[:, h0:h0+TH]
  float* wd_s = wg_s + C * TH;     // [TH][C]   W_dec[h0:h0+TH, :]
  float* enc_s = wd_s + TH * C;    // [TT][PS]  round_T(enc)
  float* pi_s = enc_s + TT * PS;   // [TT][PS]  round_T(relu(pre_gate))
  float* bg_s = pi_s + TT * PS;    // [TH]
  float* bm_s = bg_s + TH;         // [TH]
  float* er_s = bm_s + TH;         // [TH]
  float* red_s = er_s + TH;        // [kThreads]
  int* colcnt_s = reinterpret_cast<int*>(red_s + kThreads);  // [TH]
  int* rowcnt_s = colcnt_s + TH;                             // [TT]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long t0 = static_cast<long>(blockIdx.x) * TT;

  for (int i = tid; i < TT * C; i += kThreads) {
    const int r = i / C, k = i % C;
    xc_s[r * XS + k] = round_cd<T>(to_f(x[(t0 + r) * C + k]) - round_cd<T>(b_dec[k]));
  }
  for (int i = tid; i < TT; i += kThreads) rowcnt_s[i] = 0;

  float acc_r[2][CJ], acc_v[2][CJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc_r[i][j] = acc_v[i][j] = 0.f;
  int rowcnt[2] = {0, 0};
  float l1 = 0.f;

  for (int h0 = 0; h0 < H; h0 += TH) {
    __syncthreads();  // the previous tile is done with wg_s, wd_s, enc_s, pi_s
    for (int i = tid; i < C * TH; i += kThreads) {
      const int k = i / TH, l = i % TH;
      wg_s[i] = to_f(w_gate[static_cast<long>(k) * H + h0 + l]);
    }
    for (int i = tid; i < TH * C; i += kThreads)
      wd_s[i] = to_f(w_dec[static_cast<long>(h0) * C + i]);
    for (int i = tid; i < TH; i += kThreads) {
      bg_s[i] = b_gate[h0 + i];
      bm_s[i] = b_mag[h0 + i];
      er_s[i] = er[h0 + i];
      colcnt_s[i] = 0;
    }
    __syncthreads();

    // gate product g[TT, TH] = xc @ W_gate tile, rows ty*2+i, columns tx+16*j
    float g[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
    for (int k = 0; k < C; ++k) {
      float a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = xc_s[(ty * 2 + i) * XS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wg_s[k * TH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
    }
    int colc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 2 + i, col = tx + 16 * j;
        const float pg = g[i][j] + bg_s[col];
        const float pm = __fadd_rn(__fmul_rn(g[i][j], er_s[col]), bm_s[col]);
        const float enc = gate_of(pg) * fmaxf(pm, 0.f);
        const float rpi = fmaxf(pg, 0.f);
        l1 += rpi;
        const int on = enc != 0.f;
        colc[j] += on;
        rowcnt[i] += on;
        enc_s[row * PS + col] = round_cd<T>(enc);
        pi_s[row * PS + col] = round_cd<T>(rpi);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (colc[j]) atomicAdd(&colcnt_s[tx + 16 * j], colc[j]);  // integer: exact
    __syncthreads();
    for (int i = tid; i < TH; i += kThreads)
      act_part[static_cast<long>(blockIdx.x) * H + h0 + i] =
          static_cast<float>(colcnt_s[i]);

    // decode: recon += round_T(enc) @ W_dec tile, via += round_T(relu_pi) @ W_dec tile
    for (int l = 0; l < TH; ++l) {
      float ae[2], ap[2], b[CJ];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ae[i] = enc_s[(ty * 2 + i) * PS + l];
        ap[i] = pi_s[(ty * 2 + i) * PS + l];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = wd_s[l * C + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          acc_r[i][j] = fmaf(ae[i], b[j], acc_r[i][j]);
          acc_v[i][j] = fmaf(ap[i], b[j], acc_v[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = tx + 16 * j;
      const long o = (t0 + ty * 2 + i) * C + col;
      recon[o] = acc_r[i][j] + b_dec[col];
      via[o] = acc_v[i][j] + b_dec[col];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) atomicAdd(&rowcnt_s[ty * 2 + i], rowcnt[i]);
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
  return sizeof(float) * (C * kTH               // wg_s
                          + C * kTH             // wdT_s
                          + 3 * kBwdTT * (C + 1)  // xc_s, dr_s, dv_s
                          + 2 * kBwdTT * kTH    // enc_s, dg_s
                          + 4 * 16 * kTH        // sum slots
                          + 4 * kTH);           // bg_s, bm_s, er_s, bcd_s
}

// Backward. One block owns kTH latents and sweeps all T tokens in kBwdTT steps,
// recomputing the gate product per step; dW_gate[:, tile] and dW_dec[tile, :]
// stay in registers (64 + 64 floats a thread at C = 256). Thread (ty, tx) owns
// token row ty and latent columns tx + 16*j of each step's [kBwdTT, kTH] tile.
// db_dec leaves as one partial row per block: -round_T(sum dg over the tile's
// latents) @ W_gate^T, and block 0 adds the direct term sum_t drecon once.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
gated_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w_gate,
                 const float* __restrict__ b_gate, const float* __restrict__ b_mag,
                 const float* __restrict__ er, const T* __restrict__ w_dec,
                 const float* __restrict__ b_dec, const float* __restrict__ err_rec,
                 const float* __restrict__ err_via, const float* __restrict__ coeffs,
                 float* __restrict__ dw_gate, float* __restrict__ db_gate,
                 float* __restrict__ db_mag, float* __restrict__ dr_mag,
                 float* __restrict__ dw_dec, float* __restrict__ db_dec_part,
                 int n_tokens, int H) {
  constexpr int TT = kBwdTT, TH = kTH;
  constexpr int XS = C + 1;
  constexpr int CI = C / 16;  // dW_gate rows (channels) per thread
  constexpr int CJ = C / 16;  // dW_dec columns (channels) per thread
  constexpr int NS = 16 * TH; // slots of one per-latent sum
  extern __shared__ float smem[];
  float* wg_s = smem;             // [C][TH]
  float* wdT_s = wg_s + C * TH;   // [C][TH]  W_dec tile, transposed
  float* xc_s = wdT_s + C * TH;   // [TT][XS]
  float* dr_s = xc_s + TT * XS;   // [TT][XS] round_T(drecon)
  float* dv_s = dr_s + TT * XS;   // [TT][XS] round_T(dvia)
  float* enc_s = dv_s + TT * XS;  // [TT][TH] round_T(enc)
  float* dg_s = enc_s + TT * TH;  // [TT][TH] round_T(dg)
  float* sum_s = dg_s + TT * TH;  // [4][16][TH]: d_pregate, d_premag, d_premag*g, dg
  float* bg_s = sum_s + 4 * NS;   // [TH]
  float* bm_s = bg_s + TH;        // [TH]
  float* er_s = bm_s + TH;        // [TH]
  float* bcd_s = er_s + TH;       // [TH] round_T(sum dg)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h0 = blockIdx.x * TH;
  const float c_rec = coeffs[0], c_l1 = coeffs[1], c_aux = coeffs[2];

  for (int i = tid; i < C * TH; i += kThreads) {
    const int k = i / TH, l = i % TH;
    wg_s[i] = to_f(w_gate[static_cast<long>(k) * H + h0 + l]);
  }
  for (int i = tid; i < TH * C; i += kThreads) {
    const int l = i / C, k = i % C;
    wdT_s[k * TH + l] = to_f(w_dec[static_cast<long>(h0) * C + i]);
  }
  for (int i = tid; i < TH; i += kThreads) {
    bg_s[i] = b_gate[h0 + i];
    bm_s[i] = b_mag[h0 + i];
    er_s[i] = er[h0 + i];
  }
  for (int i = tid; i < 4 * NS; i += kThreads) sum_s[i] = 0.f;

  float gwg[CI][4], gwd[4][CJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gwg[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) gwd[i][j] = 0.f;
  float direct = 0.f;  // block 0, thread k < C: sum_t drecon[t, k]

  for (int t0 = 0; t0 < n_tokens; t0 += TT) {
    __syncthreads();  // the previous step is done with the token tiles
    for (int i = tid; i < TT * C; i += kThreads) {
      const int r = i / C, k = i % C;
      const long o = static_cast<long>(t0 + r) * C + k;
      xc_s[r * XS + k] = round_cd<T>(to_f(x[o]) - round_cd<T>(b_dec[k]));
      dr_s[r * XS + k] = round_cd<T>(__fmul_rn(c_rec, err_rec[o]));
      dv_s[r * XS + k] = round_cd<T>(__fmul_rn(c_aux, err_via[o]));
    }
    if (blockIdx.x == 0 && tid < C)
      for (int r = 0; r < TT; ++r)
        direct = __fadd_rn(direct,
                           __fmul_rn(c_rec, err_rec[static_cast<long>(t0 + r) * C + tid]));
    __syncthreads();

    // g, denc, d_relu_pi [TT, TH]: row ty, columns tx+16*j
    float g[4], den[4], drp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) g[j] = den[j] = drp[j] = 0.f;
    for (int k = 0; k < C; ++k) {
      const float ax = xc_s[ty * XS + k], ar = dr_s[ty * XS + k], av = dv_s[ty * XS + k];
      float b1[4], b2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = wg_s[k * TH + tx + 16 * j];
        b2[j] = wdT_s[k * TH + tx + 16 * j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[j] = fmaf(ax, b1[j], g[j]);
        den[j] = fmaf(ar, b2[j], den[j]);
        drp[j] = fmaf(av, b2[j], drp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const float e = er_s[col];
      const float pg = g[j] + bg_s[col];
      const float pm = __fadd_rn(__fmul_rn(g[j], e), bm_s[col]);
      const float gate = gate_of(pg);
      const float d_relu_pi = drp[j] + c_l1;
      const float d_premag = pm > 0.f ? __fmul_rn(den[j], gate) : 0.f;
      const float d_pregate = pg > 0.f ? d_relu_pi : 0.f;
      const float dg = __fadd_rn(__fmul_rn(d_premag, e), d_pregate);
      const int slot = ty * TH + col;  // this thread's own slot
      sum_s[slot] += d_pregate;
      sum_s[NS + slot] += d_premag;
      sum_s[2 * NS + slot] += __fmul_rn(d_premag, g[j]);
      sum_s[3 * NS + slot] += dg;
      enc_s[ty * TH + col] = round_cd<T>(gate * fmaxf(pm, 0.f));
      dg_s[ty * TH + col] = round_cd<T>(dg);
    }
    __syncthreads();

    // dW_gate[k, l] += sum_r xc[r, k] * dg[r, l]: rows k = ty*CI+i, cols tx+16*j
    for (int r = 0; r < TT; ++r) {
      float a[CI], b[4];
#pragma unroll
      for (int i = 0; i < CI; ++i) a[i] = xc_s[r * XS + ty * CI + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = dg_s[r * TH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < CI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gwg[i][j] = fmaf(a[i], b[j], gwg[i][j]);
    }
    // dW_dec[l, k] += sum_r enc[r, l] * drecon[r, k]: rows l = ty*4+i, cols tx+16*j
    for (int r = 0; r < TT; ++r) {
      float a[4], b[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = enc_s[r * TH + ty * 4 + i];
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
      dw_gate[static_cast<long>(ty * CI + i) * H + h0 + tx + 16 * j] = gwg[i][j];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      dw_dec[static_cast<long>(h0 + ty * 4 + i) * C + tx + 16 * j] = gwd[i][j];
  __syncthreads();
  for (int l = tid; l < TH; l += kThreads) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int gr = 0; gr < 16; ++gr)  // fixed order
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] += sum_s[q * NS + gr * TH + l];
    db_gate[h0 + l] = s[0];
    db_mag[h0 + l] = s[1];
    dr_mag[h0 + l] = __fmul_rn(s[2], er_s[l]);
    bcd_s[l] = round_cd<T>(s[3]);
  }
  __syncthreads();
  for (int k = tid; k < C; k += kThreads) {
    float s = 0.f;
    for (int l = 0; l < TH; ++l) s = fmaf(bcd_s[l], wg_s[k * TH + l], s);
    float v = -s;
    if (blockIdx.x == 0) v += direct;  // C <= kThreads: thread k summed column k
    db_dec_part[static_cast<long>(blockIdx.x) * C + k] = v;
  }
}

}  // namespace simt
}  // namespace

// er is exp(r_mag) [H] in f32. bf16 != 0: __nv_bfloat16 operands, x_cent an
// [n_tokens, C] bf16 workspace (center_kernel's output), act_part and l1_part
// (the zsum partials of relu_pi) [n_tokens / 64, H] (T and H multiples of 128,
// C of 8). float: gated_fwd_kernel, x_cent unused, act_part [n_tokens / 32, H],
// l1_part [n_tokens / 32]. The L1 sum is the total of l1_part either way.
extern "C" int svt_gated_fwd(int bf16, const void* x, const void* w_gate,
                             const float* b_gate, const float* b_mag, const float* er,
                             const void* w_dec, const float* b_dec, float* recon, float* via,
                             float* act_part, float* row_active, float* l1_part, void* x_cent,
                             int n_tokens, int C, int H, cudaStream_t stream) {
  if (bf16) {
    if (bad_shape(n_tokens, C, C, H) || bad_tc_operands(C, C, x, x_cent, w_gate, w_dec))
      return cudaErrorInvalidValue;
    cudaError_t e = launch_center(1, x, b_dec, x_cent, n_tokens, C, stream);
    if (e != cudaSuccess) return e;
    const svt::Levels lv = svt::one_level(H);
    ActFwd af{};
    af.b_mag = b_mag;
    af.er = er;
    if (C <= 256) {  // recon and via held together
      af.via = via;
      return fwd_tc<false, Act::Gated>(x_cent, w_gate, b_gate, w_dec, b_dec, recon, act_part,
                                       row_active, l1_part, n_tokens, C, C, H, lv, af, stream);
    }
    if ((e = fwd_tc<false, Act::GatedEnc>(x_cent, w_gate, b_gate, w_dec, b_dec, recon, act_part,
                                          row_active, nullptr, n_tokens, C, C, H, lv, af,
                                          stream)) != cudaSuccess)
      return e;
    return fwd_tc<false, Act::GatedPi>(x_cent, w_gate, b_gate, w_dec, b_dec, via, nullptr,
                                       nullptr, l1_part, n_tokens, C, C, H, lv, af, stream);
  }
  if (n_tokens <= 0 || H <= 0 || n_tokens % simt::kFwdTT || H % simt::kTH)
    return cudaErrorInvalidValue;
  return svt::dispatch_width(C, [&](auto c) {
    constexpr int CC = decltype(c)::value;
    return svt::launch(simt::gated_fwd_kernel<float, CC>, n_tokens / simt::kFwdTT,
                       simt::fwd_smem_bytes<CC>(), stream, static_cast<const float*>(x),
                       static_cast<const float*>(w_gate), b_gate, b_mag, er,
                       static_cast<const float*>(w_dec), b_dec, recon, via, act_part, row_active,
                       l1_part, H);
  });
}

// err_rec and err_via are the f32 residuals recon - x and via - x [n_tokens, C];
// coeffs is a 3-float device array (c_rec, c_l1, c_aux). bf16: x_cent [n_tokens,
// C] and err_s [2, n_tokens, C] are bf16 workspaces (center_kernel's output;
// scale_err_kernel's round_bf16(c_rec * err_rec), then round_bf16(c_aux *
// err_via)) and db_dec_part is [ceil(n_tokens / 512) + H / 64, C], the
// pre-pass's direct rows, then coder_bwd_tc<true, Act::Gated>'s centring rows
// (T and H multiples of 128, C of 8). float: gated_bwd_kernel, the workspaces
// unused, db_dec_part [H / 64, C].
extern "C" int svt_gated_bwd(int bf16, const void* x, const void* w_gate,
                             const float* b_gate, const float* b_mag, const float* er,
                             const void* w_dec, const float* b_dec, const float* err_rec,
                             const float* err_via, const float* coeffs, float* dw_gate,
                             float* db_gate, float* db_mag, float* dr_mag, float* dw_dec,
                             float* db_dec_part, void* x_cent, void* err_s, int n_tokens, int C,
                             int H, cudaStream_t stream) {
  if (bf16) {
    if (bad_shape(n_tokens, C, C, H) || bad_tc_operands(C, C, x, x_cent, w_gate, w_dec))
      return cudaErrorInvalidValue;
    const long direct = (n_tokens + kTcBwdTS - 1) / kTcBwdTS;
    __nv_bfloat16* via_s = static_cast<__nv_bfloat16*>(err_s) + static_cast<long>(n_tokens) * C;
    cudaError_t e;
    if ((e = launch_center(1, x, b_dec, x_cent, n_tokens, C, stream)) != cudaSuccess ||
        (e = launch_scale_err(err_rec, coeffs, err_s, db_dec_part, n_tokens, C, stream)) !=
            cudaSuccess ||
        (e = launch_scale_err(err_via, coeffs + 2, via_s, nullptr, n_tokens, C, stream)) !=
            cudaSuccess)
      return e;
    SaeBwd sae{svt::one_level(H), w_gate, db_dec_part + direct * C};
    sae.act.b_mag = b_mag;
    sae.act.er = er;
    sae.act.db_mag = db_mag;
    sae.act.dr_mag = dr_mag;
    return bwd_tc<true, Act::Gated>(x_cent, w_gate, b_gate, w_dec, err_s, 2 * n_tokens, coeffs,
                                    nullptr, dw_gate, db_gate, dw_dec, nullptr, n_tokens, C, C,
                                    H, sae, stream);
  }
  if (n_tokens <= 0 || H <= 0 || n_tokens % simt::kBwdTT || H % simt::kTH)
    return cudaErrorInvalidValue;
  return svt::dispatch_width(C, [&](auto c) {
    constexpr int CC = decltype(c)::value;
    return svt::launch(simt::gated_bwd_kernel<float, CC>, H / simt::kTH,
                       simt::bwd_smem_bytes<CC>(), stream, static_cast<const float*>(x),
                       static_cast<const float*>(w_gate), b_gate, b_mag, er,
                       static_cast<const float*>(w_dec), b_dec, err_rec, err_via, coeffs,
                       dw_gate, db_gate, db_mag, dr_mag, dw_dec, db_dec_part, n_tokens, H);
  });
}
