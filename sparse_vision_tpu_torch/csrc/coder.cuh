// The coder body family for Hopper (sm_90a): forward and backward of a ReLU
// dictionary that encodes x [T, Cin] and decodes into [T, Cout], and the SAEs'
// input gradient (dx) as a route of the forward bodies. Included by
// fused_transcoder.cu (the transcoder and crosscoder ops) and fused_sae.cu (the
// ReLU and Matryoshka SAE ops), whose C entry points call coder_fwd / coder_bwd
// at the end of this file (and fused_sae.cu's sae_dx launches the dx route),
// and by fused_jumprelu_sae.cu and fused_gated_sae.cu, whose bf16 forwards and
// backwards call fwd_tc / bwd_tc, and f32 ones fwd_simt / bwd_simt, with
// variant epilogues (kAct, below).
//
// Replaces these Pallas TPU kernels (sparse_vision_tpu/ops/):
//   forward  <- fused_transcoder.py _fwd_kernel (:41), pallas_call :227
//               fused_crosscoder.py _fwd_kernel (:68), pallas_call :238
//               fused_sae.py _fwd_kernel (:43), pallas_call :321
//               fused_matryoshka_sae.py _fwd_kernel (:99), pallas_call :292
//               fused_jumprelu_sae.py _fwd_kernel (:30), pallas_call :192
//               fused_gated_sae.py _fwd_kernel (:42), pallas_call :234
//   backward <- fused_transcoder.py _bwd_kernel (:91), pallas_call :264
//               fused_crosscoder.py _bwd_kernel (:109), pallas_call :274
//               fused_sae.py _bwd_kernel (:96), pallas_call :391
//               fused_matryoshka_sae.py _bwd_kernel (:155), pallas_call :371
//               fused_jumprelu_sae.py _bwd_kernel (:80), pallas_call :248
//               fused_gated_sae.py _bwd_kernel (:98), pallas_call :292
//   dx       <- fused_sae.py _dx_kernel (:168), pallas_call :422
//               fused_matryoshka_sae.py _dx_kernel (:227), pallas_call :404
// The ops differ in their L1 statistic, so one body pair serves all: the forward
// always emits per-latent sums of post (zsum partials; a scalar sum of post is
// their total) and the backward always takes a per-latent L1 cotangent ct [H]
// (the transcoder and the SAEs pass their scalar c_l1 broadcast). The
// crosscoder runs in its concatenated, scaled space (ops/fused_crosscoder.py).
//
// Shapes: x [T, Cin], W_enc [Cin, H], W_dec [H, Cout], recon and err [T, Cout].
// The bodies do not centre x: the SAE entry points write x_cent = round_T(x -
// round_T(b_dec)) first (center_kernel, below) and pass it with Cin =
// Cout = C. The SAEs' other differences are template flags, so the coder
// instantiations (both false) compile as they did before the SAEs joined:
//   kPrefix (forward; the Matryoshka SAE): recon is prefix_recon [P, T, Cout].
//     Latent groups also end at every prefix boundary (Levels; multiples of
//     128), where the block writes its running recon + b_dec into that
//     boundary's slice; the running recon is the last slice, the full one.
//   kSae (backward; both SAEs): a block of prefix level q reads err rows from
//     q*T on (err is the suffix-weighted error S [P, T, Cout], one level for
//     the ReLU SAE); the direct db_dec rows are summed by level-0 blocks only,
//     which read S_0; and each block writes one row of db_dec's centring term,
//     -round_T(db_enc tile) @ W_enc tile^T, in its epilogue (SaeBwd::db_cent
//     [H / 64, Cin], reduced by the caller; no float atomics).
//   kAct (every body; no kPrefix or kDx in the forward, kSae in the
//     backward): Act::Relu is the body above; the others are the JumpReLU and
//     gated SAEs' epilogues, with their per-latent operands from ActFwd
//     (forward) or SaeBwd::act (backward). The SIMT bodies (f32) compute the
//     same formulas; their gated forward is always the two launches below
//     (GatedEnc, GatedPi), and their backward reads the errors as the ops saved
//     them, in f32, applying c_rec (and the gated op's c_aux) itself.
//     Forward (post_epilogue): Jump keeps pre where pre > theta; Gated reads
//     one encode product g as pre_gate = g + b_gate and pre_mag = g*er + b_mag,
//     enc = gate * relu(pre_mag) is post (counted) and relu_pi = relu(pre_gate)
//     fills a second post block (summed: the L1 statistic); both decode from
//     the same W_dec tiles, so W_dec streams once (6*T*C*H FLOP). Gated runs
//     only in coder_fwd_tc_hold<256> (Cout <= 256): recon and via [64][256]
//     held together are 128 accumulator floats a consumer thread, the budget
//     of hold<512>, and the second block is 16 KB more shared memory (165,184
//     bytes). Wider, two held outputs would need 256 floats a thread and
//     spill, and coder_fwd_tc's [128][512] post buffer cannot double, so the
//     gated forward is two launches of the ordinary width route: GatedEnc
//     (enc; recon and the counts) and GatedPi (relu_pi as post; via and the
//     sums). The encode runs twice (8*T*C*H), but no body needs a new
//     structure; one launch with 256-latent groups and both outputs updated in
//     place was not taken: more code for the wide taps only.
//     Backward (coder_bwd_tc's note): Jump and Gated read err already scaled
//     and rounded by scale_err_kernel (their ops save f32 errors and the Pallas
//     kernels round c * err once, before the product).
//   kDx (the forward bodies, Act::Relu, no kPrefix; both SAEs): recon is dx
//     [T, C] and err is S [P, T, C], one level for the ReLU SAE (operands in
//     DxFwd; TcFwd for coder_fwd_tc). A dx block is a forward block with
//     three changes: its encode is followed by a second product, dpost =
//     round_T(c_rec * err) @ W_dec tile^T (err rows of the group's level;
//     groups end at every level boundary), pre having been reduced to its
//     mask bits (pre_mask); its epilogue writes round_T(dpre) where the forward
//     writes round_T(post) (dpre_epilogue); and its decode reads W_enc tiles as
//     the K-major B of round_T(dpre) @ W_enc tile^T where the forward reads
//     W_dec. No statistics; the first group (coder_fwd_tc, coder_fwd_kernel)
//     or the final store (coder_fwd_tc_hold) adds -c_rec * err_0 in f32. In
//     the bf16 bodies dpost has accumulators of its own: written into the
//     encode's, whose results were read just before, the products raced on the
//     card (wrong rows, bits that differed between launches).
//
// The bodies, chosen by the operand type:
//   bf16 (the training path): coder_fwd_tc_hold (Cout <= 512; recon or dx held
//     in registers, 256 or 512 columns by a template width; 148,800 bytes of
//     shared memory), coder_fwd_tc (wider: the crosscoder, SAEs at C 528-1,024;
//     230,960 bytes), coder_bwd_tc and, for the transcoder's widths (Cin <= 256
//     < Cout <= 512; ops/fused_sae.bwd_route), coder_bwd_held's two passes,
//     and for the JumpReLU, ReLU and Matryoshka SAEs' at C <= 256
//     coder_bwd_pair (two CTAs of a thread block cluster a latent block;
//     Act::Jump, Act::Relu), 256 threads = two warpgroups, up to
//     255 registers a thread and no spills (chip_smoke.py's build phase
//     checks).
//     Every product runs on the tensor cores as
//     wgmma.mma_async m64n64k16 (bf16 in, f32 accumulators in registers), B
//     always and A mostly read straight from shared memory through wgmma
//     descriptors; where an operand is round_bf16(c_rec * err), A comes from
//     registers instead (ldmatrix, scaled and rounded there: scaled_frags and
//     coder_bwd_tc's err_frags), so err streams as it is stored. Operands
//     arrive by TMA (cp.async.bulk.tensor.2d, boxes of [64 or 32 rows][64
//     columns] in the 128-byte swizzle that wgmma reads)
//     into a ring of 3 or 4 slots guarded by mbarriers: a full barrier per
//     slot counts the TMA bytes, an empty barrier the eight warps that have
//     finished with it. Thread 0 issues the stream kSt - 1 tiles ahead, each
//     into the slot just released; the warps wait only on the tile they
//     multiply, keep one tile's products in flight, and the block has no
//     barrier per tile. The tensor maps are built per call in the C entry
//     points (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so no
//     -lcuda) and passed as __grid_constant__ parameters. TMA's zero fill past
//     an edge takes the ragged widths (480 = 7*64 + 32, 2,896 = 45*64 + 16);
//     its 16-byte row strides need bf16 widths that are multiples of 8.
//     No separate producer warp: a block of 9 or 12 warps gets 168 registers a
//     thread (each SM's four register banks hold 16,384 each), setmaxnreg did
//     not raise the consumers' budget under nvcc 12.8, and the bodies spilled.
//   f32 (the check path): coder_fwd_kernel<float> (with the dx route and the
//     kAct epilogues) and coder_bwd_kernel<float> (kAct too), the SIMT FMA
//     bodies of the first port (TF32 would miss the f32 tolerances). Any
//     positive width.
//
// What bounds them. At the transcoder's training shape (T = 32,768, H = 16,384,
// 256 -> 480) the forward is 2*T*H*(Cin+Cout) = 0.79 TFLOP and the backward twice
// that; at the crosscoder's (T = 16,384, H = 8,192, Cin = Cout = 2,896) 1.55 and
// 3.1 TFLOP; at the SAEs' (T = 32,768, C = 256, H = 16,384) 0.55 and 1.1 TFLOP
// (the gated SAE's 0.82 and 1.4, the SAEs' dx 6*T*C*H = 0.82): 0.6-3.1 ms at
// the 989 TFLOP/s of bf16 tensor cores. Operands are ~0.05-0.2 GB
// (0.02-0.13 ms at 3.35 TB/s; ~0.15 GB more with the Matryoshka prefix
// reconstructions): bounded by arithmetic as long as the [T, H] latent matrix
// never reaches device memory.
//
// Tiling, and the device-memory traffic of outputs updated in place (from the
// shapes; read-modify-write by their only owner, one thread of one block, in a
// fixed order: bitwise repeatable, no atomics):
//   coder_fwd_tc_hold<W>: a block owns 64 tokens; recon [64, W] f32 (W = 256
//     for Cout <= 256, else 512) stays in registers (warpgroup g: columns
//     gW/2 .. gW/2 + W/2 - 1, W/4 a thread) for the whole latent sweep and is
//     written once (and at each prefix boundary): no update traffic. Per group
//     of 128 latents: pre [64, 128] = x @ W_enc (warpgroup g: 64 latents),
//     whose round_bf16(post) fills post_s [64, 128] with the statistics taken
//     in the epilogue, then recon += post_s @ W_dec. Each block streams all of
//     W_enc and W_dec (24 MB at the transcoder's shape, 16 MB at the SAE's)
//     through L2. Act::Gated holds via [64, 256] beside recon and fills pi_s
//     [64, 128] beside post_s; each W_dec tile feeds both decodes. kDx (C <=
//     256: W = 256 only) holds dx [64, 256] as recon and writes it once
//     (T*C*4 bytes, 32 MB at the SAE's shape); per group the stream adds err
//     [64, C] and W_dec [128, C] (dpost, A from registers), and the decode's
//     tiles are W_enc [256, 128] (each warpgroup's 128 columns, 64 at a time):
//     each block streams W_enc twice and W_dec once, 24 MB at the SAE's shape,
//     through L2. dx's 64 floats a thread, dpost's accumulators (32) and its A
//     fragments (16) are live together, pre only as 32 mask bits; at W = 512
//     (128 floats of dx) that spilled, so 256 < C <= 512 takes coder_fwd_tc.
//   coder_fwd_tc: recon [128, 2,896] f32 (1.5 MB) does not fit. A block owns 128
//     tokens (64 per warpgroup) and sweeps the latents in groups of up to 512:
//     up to four encode sub-tiles pre [128, 128] fill post_s [128, 512], then
//     for each 128 output columns acc = post_s @ W_dec is added into recon.
//     Groups end at skew + 512k, skew = 128 * (block % 4), so that the blocks'
//     updates do not all fall at once (a split: from its first latent on). recon is updated about H/512 times:
//     ~(2H/512 + 1)*T*Cout*4 bytes, 6.2 GB (1.8 ms at 3.35 TB/s) for the
//     crosscoder. kDx updates dx [128, C] in place the same way (groups also
//     end at level boundaries): per 128-latent sub-tile the stream adds err
//     [128, 64] and W_dec [128, 64] per 64 channels after the encode's tiles,
//     round_bf16(dpre) fills post_s, and the decode reads W_enc [128, 64]
//     tiles (K-major); ~(2H/512 + 1)*T*C*4 bytes of updates, 7.1 GB (2.1 ms) at
//     C 832, T 32,768, H 16,384 against 2.7 TFLOP (2.7 ms) of products.
//   coder_bwd_tc: dW_enc and dW_dec of a 64-latent block (1.5 MB for the
//     crosscoder) do not fit. A block owns 64 latents and sweeps the tokens in
//     steps of 512. Per step: A. for each 128 tokens (64 per warpgroup), pre and
//     dpost [128, 64] (x @ W_enc tile, round_bf16(c_rec*err) @ W_dec tile^T),
//     round_bf16(post) and round_bf16(dpre) into post_s and dpre_s [512, 64];
//     B. for each 128 input channels (64 per warpgroup), x^T @ dpre_s over the
//     512 tokens, added into dW_enc; C. for each 128 output columns (64 per
//     warpgroup), (round_bf16(c_rec*err)^T @ post_s)^T, added into dW_dec. dW
//     is updated T/512 times: (2T/512 - 1)*(Cin+Cout)*H*4 bytes = 6.1 GB
//     (1.8 ms) for the transcoder, 12.0 GB (3.6 ms) for the crosscoder.
//     From L2 the blocks read ~1.9 MB a step each (phase A 1.15 MB, B 0.25, C
//     0.5 at 256 -> 480), ~7.8 GB a launch at a (2, 2) rank's transcoder shard
//     (T 16,384, H 8,192), ~6.2 GB of it x and err tiles that every block
//     reads alike. Measured there on the H100 (chip_bwd_probe.py's ablated
//     copies, PERF.md): without the dW updates 0.707 of the time, without the
//     products (every load kept) 0.602, with every other block loading no x
//     or err tile 0.976. So the token tiles' L2 traffic does not bound it
//     (pairs of blocks in a thread block cluster that shared each x and err
//     box by TMA multicast ran 0.93-0.97x as fast); the updates (27%) and the
//     loads, epilogues and barriers that no product overlaps do (the products
//     alone 0.8 ms against a 0.40 ms bound). Overlapping a chunk's update with
//     the next chunk's products needs a second accumulator set, and the body
//     spilled at 255 registers.
//   coder_bwd_held (the transcoder: Cin <= 256 < Cout <= 512): the same blocks
//     in two launches, pass E holding dW_enc [Cin, 64] (64 registers a thread)
//     and pass D dW_dec [64, Cout] (128) in registers for the whole token sweep,
//     each written once: no update traffic, at the price of pre recomputed in
//     pass D (2*T*H*(3*Cin + 2*Cout) FLOP in all). The W tiles stay in shared
//     memory; the ring streams x and err only (pass E x twice). At a (2, 2)
//     rank's transcoder shard 1.10x coder_bwd_tc (PERF.md's kernel table); at C 256
//     (the SAEs) no faster, so those keep coder_bwd_tc.
//   coder_bwd_pair (the JumpReLU, ReLU, Matryoshka and gated SAEs at C <= 256): a
//     latent block is a cluster of two CTAs, E holding dW_enc [C, 64] and D
//     dW_dec^T [C, 64], each warpgroup its own tile of every other 64-token
//     sub-step (128 registers a thread); E sends round_bf16(post) and the mask
//     (and JumpReLU window) bits, D sends round_bf16(dpre) back, by bulk
//     copies into the peer's shared memory (the gated SAE: E sends g in f32,
//     D runs the epilogue and three products and sends round_bf16(dg)). Each
//     tile is written once and each rank reads its token tiles once (E x, D
//     err), its W tile resident: ~T*C*2 bytes a rank from L2 where
//     coder_bwd_tc reads ~5*T*C*2. 1.2-1.85x coder_bwd_tc at rows 2, 5, 7, 9,
//     16, 18, 20, 22, 28, 30, 32 and 34 (PERF.md's kernel table).
// Blocks stream the same tiles in step, so each comes from device memory about
// once a wave and from L2 after that.

// Numerics follow the Pallas kernels' cast points. The operand type T (float
// or bf16) is the compute dtype; x, W_enc, W_dec and err arrive already cast:
//   pre    = x @ W_enc (f32 sum) + b_enc     post = max(pre, 0)
//   recon  = sum_j round_T(post_j) @ W_dec_j + b_dec    (f32; b_dec in f32)
//   drecon = c_rec * err (f32; the products read round_T(drecon))
//   dpost  = round_T(drecon) @ W_dec^T + ct     dpre = pre > 0 ? dpost : 0
//   dW_enc = x^T @ round_T(dpre)    db_enc = sum_t dpre
//   dW_dec = round_T(post)^T @ round_T(drecon)    db_dec = sum_t drecon
//   dx     = sum_j round_T(dpre_j) @ W_enc_j^T - drecon_0    (kDx; f32)
// Cross-block sums (activity counts, zsum) leave as per-64-token partials that
// the caller reduces; db_dec, which does not depend on the latents, leaves as
// partials too: two over alternate token rows from block 0 (f32), one per
// 512-token step from the (level-0) block that step's index selects (bf16).
//
// coder_fwd and coder_bwd return the cudaError_t of the launch (the entry points
// pass it on; the Python wrappers raise on a non-zero value). Supported shapes
// (bad_shape, bad_tc_operands): T a multiple of 128, H a multiple of 128, prefix
// boundaries multiples of 128; with bf16 operands Cin and Cout multiples of 8
// and the bf16 operands 16-byte aligned (ops/fused_sae.bodies_take).
//
// Combos (the sweep's stacked dictionaries, train/sweep_vmap.py; the Pallas
// kernels' vmap batching rule, which adds the combo as the outer grid
// dimension): every body takes N dictionaries of one shape in one launch, on a
// grid of (one dictionary's blocks, N). Combo n = blockIdx.y reads and writes
// its own part of each stacked operand, the combo outermost: x [N, T, Cin],
// W_enc [N, Cin, H], b_enc [N, H], W_dec [N, H, Cout], b_dec [N, Cout], err [N,
// P*T, Cout] (gated [N, 2*T, Cout]), coeffs [N, 2] (gated [N, 3]), ct and the
// per-latent operands [N, H]; recon [N, P, T, Cout], act_part and zsum_part
// [N, T/64, H], row_active [N, T], the gradients [N, ...] and db_dec_part [N,
// direct rows + H/64, C]. gridDim.x stays one dictionary's grid, so every
// slice, owner and level the bodies derive from it (the prefix slices, db_dec's
// step owners) is a one-dictionary launch's. The bf16 bodies' tensor maps are
// rank 3, {cols, rows, N} with boxes one deep, read at depth blockIdx.y
// (tma_box): a box past a combo's last row or column fills zeros, as the map
// of one matrix does, and never reads the next combo's rows. The pointer
// operands move by blockIdx.y times a combo's elements where they are used
// (combo_part). A one-dictionary launch is the case N = 1 of the same code, so
// combo n of a launch runs the instructions of a one-dictionary launch on
// combo n's operands and gives its bits. The dx route runs one dictionary.
//
// Splits (the bf16 bodies coder_fwd_tc and coder_bwd_tc; the number s comes
// from ops/fused_sae.grid_split, which reads one dictionary's shape and the
// card's SM count, never N): a body pinned at one block an SM whose grid of one
// dictionary leaves SMs idle (the crosscoder at a (2, 2) rank's shard: 64 of
// 132) cuts each block's sweep into s parts on the grid's z dimension, grid
// (one dictionary's blocks, N, s). gridDim.x and gridDim.y stay as they are,
// so every owner, level and combo slice derived from them is an unsplit
// launch's, and so is a combo's s whatever N is. Split z writes partials of
// its own, the split outermost (split_part, split_dw): no float atomics.
//   coder_bwd_tc: split z sweeps the 512-token steps [z*n/s, (z+1)*n/s) of the
//     n = ceil(T / 512), its first step writing its partial of dW_enc and
//     dW_dec, later steps adding: split 0's partial is the output itself,
//     split z >= 1's lies in the caller's workspace split_ws (split_dw). Its
//     per-latent sums (db_enc; Jump: dtheta; Gated: db_mag, the sum behind
//     dr_mag, sum dg) leave as rows of the workspace too, and an integer ticket
//     a latent block (zeroed by the caller) counts its splits done: the split
//     that draws the last ticket adds the other splits' dW tiles into the
//     outputs and the s rows of sums, each in split order, and ends as an
//     unsplit block ends (last_split, add_split_tiles): the per-latent outputs,
//     and db_dec's centring row, which needs the whole db_enc before its bf16
//     rounding. split_ws: dW_enc [s - 1, N, Cin, H], dW_dec [s - 1, N, H,
//     Cout], the sums [s, N, kSplitSums, H] f32, the tickets [N, H / 64] int.
//     db_dec_part's rows are per step, so they stay disjoint: step si's owner
//     is the block of si's own split that si selects. The launch's blocks are
//     numbered so that a latent block's splits are neighbours (bwd_block).
//     The split does not change which products a step adds, only where they
//     are summed: (((p0 + p1) + p2) + p3) of the splits' partials.
//   coder_fwd_tc: split z sweeps the latents of the 512-latent groups [z*G/s,
//     (z+1)*G/s) of the G = ceil(H / 512), its groups skewed within that
//     range, into its own recon [s, N, (P,) T, Cout]: split 0 adds b_dec, the
//     others start from 0. row_active [s, N, T] counts each split's active
//     latents (the sum is exact: integers). act_part and zsum_part are
//     per-latent columns, so the splits write disjoint parts of them. kPrefix:
//     a split also writes every prefix slice that ends outside its range, 0
//     below it and its own last slice above it, so each slice's sum over s is
//     the unsplit one's.
// The caller sums the forward's [s, ...] partials over s (one .sum(0), the same
// order for every element and every N); the backward's sums are the last
// split's, in the kernel, where they overlap the other blocks' products (as a
// .sum(0) of [s, ...] dW partials the sweep's backward at N 8 ran 11-14% slower
// split than unsplit, PERF.md). s = 1 is the launch without a split: the same
// grid, buffers and bits. The register-held forwards, the dx route and the
// SIMT bodies do not split.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

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

// The epilogue of the bodies (kAct; header note): the ReLU of the coder family,
// the JumpReLU SAE's or the gated SAE's; GatedEnc and GatedPi are the two
// halves of the gated forward's two-launch route (forward only).
enum class Act { Relu, Jump, Gated, GatedEnc, GatedPi };

// The dx route's operands (kDx; header note), an empty struct in the forward:
// the trailing parameter of coder_fwd_tc_hold and coder_fwd_kernel. m_err maps
// err for the bf16 body's TMA.
template <bool kDx>
struct DxFwd {};
template <>
struct DxFwd<true> {
  CUtensorMap m_err;    // err [P * T, Cout] bf16, boxes [64][64]
  const float* coeffs;  // (c_rec, c_l1) on the device
  const void* err;      // err in the operand type: level q's rows from q * T
};

// The JumpReLU and gated SAEs' per-latent operands of the bf16 forward (kAct),
// and the gated two-output body's second output.
struct ActFwd {
  const float* theta;  // Jump: exp(log_threshold) [H]
  const float* b_mag;  // Gated*: [H]
  const float* er;     // Gated*: exp(r_mag) [H]
  float* via;          // Gated: via_gate [T, Cout] f32
};

// coder_fwd_tc's operands beyond the coder's: ActFwd, and the dx route's
// (kDx; DxFwd's fields), in one grid-constant parameter. The register-held and
// SIMT bodies take ActFwd and a trailing DxFwd instead. These are the layouts
// that leave every other instantiation's registers as they were: a trailing
// parameter on coder_fwd_tc moved coder_fwd_tc<false, Act::Jump>'s, and the
// dx fields in the held body's ActFwd made the gated one spill.
struct TcFwd {
  CUtensorMap m_err;    // kDx: as DxFwd's
  ActFwd act;
  const float* coeffs;  // kDx
  const void* err;      // kDx
};

// Combo blockIdx.y's part of a stacked operand of ``stride`` elements a combo
// (header note, "Combos"); the operand itself in a one-dictionary launch.
template <typename P>
__device__ __forceinline__ P combo_part(P p, long stride, int combo) {
  return p + static_cast<long>(combo) * stride;
}
template <typename P>
__device__ __forceinline__ P combo_part(P p, long stride) {
  return combo_part(p, stride, static_cast<int>(blockIdx.y));
}

// Split blockIdx.z's part of combo blockIdx.y's output [s, N, ``stride``
// elements] (header note, "Splits"); combo_part's in a launch without a split.
template <typename P>
__device__ __forceinline__ P split_part(P p, long stride) {
  return p + (static_cast<long>(blockIdx.z) * gridDim.y + blockIdx.y) * stride;
}

// ActFwd's per-latent operands ([N, H]) and via ([N, T, Cout], ``out`` floats
// a combo) at combo blockIdx.y; a field the epilogue does not read may be null
// and is left so.
__device__ __forceinline__ ActFwd combo_act(ActFwd a, int H, long out) {
  if (a.theta) a.theta = combo_part(a.theta, H);
  if (a.b_mag) a.b_mag = combo_part(a.b_mag, H);
  if (a.er) a.er = combo_part(a.er, H);
  if (a.via) a.via = combo_part(a.via, out);
  return a;
}

// Forward. One block owns kFwdTT tokens and sweeps the latents in groups of
// kFwdLG. Per group: pre [64, 128] by a K-loop over the input channels (rows
// ty*4+i, columns tx+16*j), post into shared memory with the group's
// statistics, then a sweep of the output columns in chunks of kFwdNC: acc
// [64, 128] (rows ty*4+i, columns tx+16*j) over the group's latents, added
// into recon in device memory by the thread that owns those elements (kPrefix:
// recon's last slice, copied into the slice of a prefix that ends with the
// group).
// kDx (recon is dx [T, C]): pre's mask stays as bits, a second K-loop over
// the err channels (of the group's level) gives dpost in pre's registers,
// round_T(dpre) takes post's place, and the decode reads W_enc^T; the first
// group writes -c_rec * err_0 + acc, no statistics.
// kAct (no kPrefix, no kDx; the f32 JumpReLU and gated SAEs): post_epilogue's
// formulas with af's per-latent operands read from device memory. Jump: post
// = pre > theta ? pre : 0, counted where != 0, summed. GatedEnc / GatedPi, the
// gated forward's two launches (recon is updated in place, so one body cannot
// hold recon and via): pre is the gate product g, b_enc is b_gate; GatedEnc
// decodes enc into recon with the counts (no zsum_part), GatedPi relu(pre_gate)
// into via (passed as recon) with its sums (no act_part, no row_active).
template <typename T, bool kPrefix, bool kDx = false, Act kAct = Act::Relu>
__global__ void __launch_bounds__(kThreads, 1)
coder_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
                 const float* __restrict__ b_enc, const T* __restrict__ w_dec,
                 const float* __restrict__ b_dec, float* __restrict__ recon,
                 float* __restrict__ act_part, float* __restrict__ row_active,
                 float* __restrict__ zsum_part, int Cin, int Cout, int H,
                 const svt::Levels lv, const DxFwd<kDx> dxf, const ActFwd af_in) {
  static_assert(kAct != Act::Gated, "the SIMT gated forward is GatedEnc, then GatedPi");
  static_assert(kAct == Act::Relu || !(kPrefix || kDx), "kAct epilogues: no kPrefix, no kDx");
  constexpr bool kCount = kAct != Act::GatedPi, kSum = kAct != Act::GatedEnc;
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
  const long n_tok = static_cast<long>(gridDim.x) * TT;  // one combo's tokens
  const long slice = n_tok * Cout;                        // one prefix's recon
  // combo blockIdx.y's operands (header note, "Combos"); kDx runs one combo
  x = combo_part(x, n_tok * Cin);
  w_enc = combo_part(w_enc, static_cast<long>(Cin) * H);
  w_dec = combo_part(w_dec, static_cast<long>(H) * Cout);
  b_enc = combo_part(b_enc, H);
  if constexpr (!kDx) {
    b_dec = combo_part(b_dec, Cout);
    if constexpr (kCount) act_part = combo_part(act_part, n_tok / TT * H);
    if constexpr (kCount) row_active = combo_part(row_active, n_tok);
    if constexpr (kSum) zsum_part = combo_part(zsum_part, n_tok / TT * H);
  }
  recon = combo_part(recon, (kPrefix ? lv.n : 1) * slice);
  const ActFwd af = combo_act(af_in, H, slice);
  float* out = kPrefix ? recon + (lv.n - 1) * slice : recon;

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

    if constexpr (kDx) {
      // pre > 0 as bits; then dpost = round_T(c_rec * err) @ W_dec tile^T in
      // pre's registers and round_T(dpre) into post_s
      const float c_rec = dxf.coeffs[0], c_l1 = dxf.coeffs[1];
      const T* e = static_cast<const T*>(dxf.err) +
                   svt::level_of(lv, g0) * (static_cast<long>(gridDim.x) * TT * Cout);
      uint32_t on = 0;  // bit 8i + j
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          on |= static_cast<uint32_t>(pre[i][j] + benc_s[tx + 16 * j] > 0.f) << (8 * i + j);
          pre[i][j] = 0.f;
        }
      for (int k0 = 0; k0 < Cout; k0 += KC) {
        __syncthreads();  // the previous chunk is done with xs, ws
        for (int i = tid; i < TT * KC; i += kThreads) {
          const int r = i / KC, k = k0 + i % KC;
          xs[r * XS + i % KC] = k < Cout ? round_cd<T>(c_rec * to_f(e[(t0 + r) * Cout + k])) : 0.f;
        }
        for (int i = tid; i < KC * LG; i += kThreads) {  // W_dec rows, read along the channels
          const int l = i / KC, kk = i % KC, k = k0 + kk;
          ws[kk * LG + l] = k < Cout ? to_f(w_dec[static_cast<long>(g0 + l) * Cout + k]) : 0.f;
        }
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
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          post_s[(ty * 4 + i) * PS + tx + 16 * j] =
              round_cd<T>((on >> (8 * i + j)) & 1u ? pre[i][j] + c_l1 : 0.f);
    } else {
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
          if constexpr (kAct == Act::Relu) {
            const float p = fmaxf(pre[i][j] + benc_s[col], 0.f);
            const int on = p > 0.f;
            colc[j] += on;
            zs[j] += p;
            rowc[i] += on;
            post_s[(ty * 4 + i) * PS + col] = round_cd<T>(p);
          } else {
            float p, q;  // post, and the summed value
            int on;
            if constexpr (kAct == Act::Jump) {
              const float v = pre[i][j] + benc_s[col];
              p = v > af.theta[g0 + col] ? v : 0.f;
              on = p != 0.f;
              q = p;
            } else {  // as post_epilogue's, rounded apart as the plain version
              const float g = pre[i][j], pg = g + benc_s[col];
              const float pm = __fadd_rn(__fmul_rn(g, af.er[g0 + col]), af.b_mag[g0 + col]);
              const float gate = pg > 0.f ? 1.f : (pg == 0.f ? 0.5f : 0.f);
              const float enc = __fmul_rn(gate, fmaxf(pm, 0.f));
              q = fmaxf(pg, 0.f);
              p = kAct == Act::GatedPi ? q : enc;
              on = enc != 0.f;
            }
            if constexpr (kCount) {
              colc[j] += on;
              rowc[i] += on;
            }
            if constexpr (kSum) zs[j] += q;
            post_s[(ty * 4 + i) * PS + col] = round_cd<T>(p);
          }
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
        if constexpr (kCount) act_part[o] = static_cast<float>(c);
        if constexpr (kSum) zsum_part[o] = z;
      }
    }

    // decode: recon[:, c0:c0+NC] += round_T(post) @ W_dec[g0:g0+LG, c0:c0+NC]
    // (kDx: dx[:, c0:c0+NC] += round_T(dpre) @ W_enc[c0:c0+NC, g0:g0+LG]^T)
    float* snap = nullptr;  // kPrefix: the slice of a prefix that ends with this group
    if constexpr (kPrefix)
      if (g0 + LG < H && svt::ends_level(lv, g0 + LG))
        snap = recon + svt::level_of(lv, g0) * slice;
    for (int c0 = 0; c0 < Cout; c0 += NC) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int l0 = 0; l0 < LG; l0 += LS) {
        __syncthreads();  // post_s is complete; the previous sub-tile is done with wd_s
        if constexpr (kDx) {
          for (int i = tid; i < LS * NC; i += kThreads) {  // W_enc rows, read along the latents
            const int col = c0 + i / LS, l = i % LS;
            wd_s[l * NC + i / LS] =
                col < Cout ? to_f(w_enc[static_cast<long>(col) * H + g0 + l0 + l]) : 0.f;
          }
        } else {
          for (int i = tid; i < LS * NC; i += kThreads) {
            const int l = i / NC, col = c0 + i % NC;
            wd_s[i] = col < Cout ? to_f(w_dec[static_cast<long>(g0 + l0 + l) * Cout + col]) : 0.f;
          }
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
            float init;
            if constexpr (kDx)  // -c_rec * err_0 (f32, not rounded)
              init = g0 == 0 ? -__fmul_rn(dxf.coeffs[0],
                                          to_f(static_cast<const T*>(dxf.err)[o]))
                             : out[o];
            else
              init = g0 == 0 ? b_dec[col] : out[o];
            const float v = init + acc[i][j];
            out[o] = v;
            if constexpr (kPrefix)
              if (snap) snap[o] = v;
          }
        }
    }
  }

  if constexpr (!kDx && kCount) {
#pragma unroll
    for (int i = 0; i < 4; ++i) atomicAdd(&rcnt_s[ty * 4 + i], rowc[i]);  // integer: exact
    __syncthreads();
    for (int i = tid; i < TT; i += kThreads) row_active[t0 + i] = static_cast<float>(rcnt_s[i]);
  }
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

// The JumpReLU and gated SAEs' per-latent operands and outputs (kAct).
struct ActBwd {
  const float* theta;  // Jump: exp(log_threshold) [H]
  float* dtheta;       // Jump: [H]
  float eps, half_eps, neg_inv_eps;  // Jump: the STE bandwidth, eps / 2, -1 / eps
  const float* b_mag;  // Gated: [H]
  const float* er;     // Gated: exp(r_mag) [H]
  float* db_mag;       // Gated: [H]
  float* dr_mag;       // Gated: [H]
};

// The SAEs' additions to the backward (kSae; header note).
struct SaeBwd {
  svt::Levels lv;      // prefix levels: a block of level q reads err rows q*T..
  const void* w_enc;   // W_enc [Cin, H] in the operand type, for the centring term
  float* db_cent;      // [H / 64, Cin]: -round_T(db_enc tile) @ W_enc tile^T per block
  ActBwd act;          // kAct != Act::Relu only
};

// SaeBwd's pointers at combo blockIdx.y (header note, "Combos"): db_cent moves
// by ``part`` floats (a combo's db_dec_part), the per-latent ones by H; w_enc is
// read through the body's own operand. Null fields stay null.
__device__ __forceinline__ SaeBwd combo_sae(SaeBwd s, int H, long part) {
  if (s.db_cent) s.db_cent = combo_part(s.db_cent, part);
  ActBwd& a = s.act;
  if (a.theta) a.theta = combo_part(a.theta, H);
  if (a.dtheta) a.dtheta = combo_part(a.dtheta, H);
  if (a.b_mag) a.b_mag = combo_part(a.b_mag, H);
  if (a.er) a.er = combo_part(a.er, H);
  if (a.db_mag) a.db_mag = combo_part(a.db_mag, H);
  if (a.dr_mag) a.dr_mag = combo_part(a.dr_mag, H);
  return s;
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
// has one owning thread, which updates it in token order. kSae: err is the
// block's level's slice; block 0 (level 0) sums the direct db_dec rows.
// kAct (with kSae; the f32 JumpReLU and gated SAEs): the epilogue of phase A
// is coder_bwd_tc's, on err as the op saved it (c_rec and round_T applied
// here, as for the ReLU); ct is not read.
//   Jump (coeffs c_rec, c_l0): the strict mask pre > theta, no L1 cotangent,
//     and the STE window's dtheta = sum_t [|pre - theta| <= eps/2] * (dpost *
//     (-theta/eps) + c_l0 * (-1/eps)) into sae.act.dtheta.
//   Gated (coeffs c_rec, c_l1, c_aux; err [2, T, Cout]: err_rec, then
//     err_via): pre holds g, a third product d_relu_pi = round_T(c_aux *
//     err_via) @ W_dec tile^T, post_s gets round_T(enc), dpre_s round_T(dg);
//     db_enc is db_gate, sae.act.db_mag and dr_mag = (sum d_premag * g) * er
//     the other sums, and db_dec's centring row reads round_T(sum dg).
template <typename T, bool kSae, Act kAct = Act::Relu>
__global__ void __launch_bounds__(kThreads, 1)
coder_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w_enc,
                 const float* __restrict__ b_enc, const T* __restrict__ w_dec,
                 const T* __restrict__ err, const float* __restrict__ coeffs,
                 const float* __restrict__ ct, float* __restrict__ dw_enc,
                 float* __restrict__ db_enc, float* __restrict__ dw_dec,
                 float* __restrict__ db_dec_part, int n_tokens, int Cin, int Cout, int H,
                 const SaeBwd sae_in) {
  static_assert(kAct == Act::Relu || kAct == Act::Jump || kAct == Act::Gated,
                "an epilogue of the backward");
  static_assert(kAct == Act::Relu || kSae, "the JumpReLU and gated backwards are SAEs'");
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
  // combo blockIdx.y's operands (header note, "Combos"): err holds P levels
  // (gated: err_rec and err_via), db_dec_part F32_DIRECT_ROWS direct rows, then
  // (kSae) the H / 64 centring rows that sae.db_cent points into
  const long n_tok = n_tokens;
  x = combo_part(x, n_tok * Cin);
  w_enc = combo_part(w_enc, static_cast<long>(Cin) * H);
  w_dec = combo_part(w_dec, static_cast<long>(H) * Cout);
  b_enc = combo_part(b_enc, H);
  err = combo_part(err, (kAct == Act::Gated ? 2 : kSae ? sae_in.lv.n : 1) * n_tok * Cout);
  coeffs = combo_part(coeffs, kAct == Act::Gated ? 3 : 2);
  if constexpr (kAct == Act::Relu) ct = combo_part(ct, H);
  dw_enc = combo_part(dw_enc, static_cast<long>(Cin) * H);
  db_enc = combo_part(db_enc, H);
  dw_dec = combo_part(dw_dec, static_cast<long>(H) * Cout);
  const long part = 2L * Cout + (kSae ? static_cast<long>(H / TH) * Cin : 0);
  db_dec_part = combo_part(db_dec_part, part);
  const SaeBwd sae = combo_sae(sae_in, H, part);
  const float c_rec = coeffs[0];
  if constexpr (kSae) err += static_cast<long>(svt::level_of(sae.lv, h0)) * n_tokens * Cout;

  for (int i = tid; i < TH; i += kThreads) {
    benc_s[i] = b_enc[h0 + i];
    if constexpr (kAct == Act::Relu) ct_s[i] = ct[h0 + i];
    else if constexpr (kAct == Act::Jump) ct_s[i] = sae.act.theta[h0 + i];
    else ct_s[i] = sae.act.b_mag[h0 + i];
  }
  float gbe[4] = {0.f, 0.f, 0.f, 0.f};
  // kAct: the sums beyond db_enc's (Jump: dtheta; Gated: d_premag, d_premag *
  // g, dg) of this thread's columns, and one per-column operand (Jump:
  // -theta/eps; Gated: er); c_1 is c_l0 * (-1/eps) (Jump) or c_l1 (Gated)
  constexpr int kNS = kAct == Act::Gated ? 3 : 1;
  float vs[kNS][4], v2[4], c_1 = 0.f;
  if constexpr (kAct != Act::Relu) {
    __syncthreads();  // ct_s is complete
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
#pragma unroll
      for (int q = 0; q < kNS; ++q) vs[q][j] = 0.f;
      v2[j] = kAct == Act::Jump ? __fdiv_rn(-ct_s[col], sae.act.eps) : sae.act.er[h0 + col];
    }
    c_1 = kAct == Act::Jump ? __fmul_rn(coeffs[1], sae.act.neg_inv_eps) : coeffs[1];
  }

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
        if constexpr (kAct == Act::Gated)
          pre[i][j] = acc[i][j];  // g: b_gate is added in the epilogue
        else
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
    if constexpr (kAct == Act::Relu) {
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
    } else if constexpr (kAct == Act::Jump) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ty * 8 + i, col = tx + 16 * j;
          const float v = pre[i][j], th = ct_s[col], dpost = acc[i][j];
          const bool on = v > th;
          const float dp = on ? dpost : 0.f;
          gbe[j] += dp;
          if (fabsf(v - th) <= sae.act.half_eps)
            vs[0][j] += __fadd_rn(__fmul_rn(dpost, v2[j]), c_1);
          post_s[row * TH + col] = round_cd<T>(on ? v : 0.f);
          dpre_s[row * TH + col] = round_cd<T>(dp);
        }
    } else {
      // d_relu_pi = round_T(c_aux * err_via) @ W_dec tile^T, the products above
      // on the second error (its chunks staged as the first's)
      const float c_aux = coeffs[2];
      const T* ev = err + static_cast<long>(n_tokens) * Cout;
      float drp[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) drp[i][j] = 0.f;
      for (int k0 = 0; k0 < Cout; k0 += KC) {
        __syncthreads();
        for (int i = tid; i < TB * KC; i += kThreads) {
          const int r = i / KC, k = k0 + i % KC;
          as_[r * XS + i % KC] =
              k < Cout ? round_cd<T>(c_aux * to_f(ev[static_cast<long>(t0 + r) * Cout + k]))
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
            for (int j = 0; j < 4; ++j) drp[i][j] = fmaf(a[i], b[j], drp[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ty * 8 + i, col = tx + 16 * j;
          const float g = pre[i][j], e = v2[j];
          const float pg = g + benc_s[col];
          const float pm = __fadd_rn(__fmul_rn(g, e), ct_s[col]);  // as the plain version
          const float gate = pg > 0.f ? 1.f : (pg == 0.f ? 0.5f : 0.f);
          const float dm = pm > 0.f ? __fmul_rn(acc[i][j], gate) : 0.f;
          const float dpg = pg > 0.f ? drp[i][j] + c_1 : 0.f;
          const float dg = __fadd_rn(__fmul_rn(dm, e), dpg);
          gbe[j] += dpg;
          vs[0][j] += dm;
          vs[1][j] += __fmul_rn(dm, g);
          vs[2][j] += dg;
          post_s[row * TH + col] = round_cd<T>(gate * fmaxf(pm, 0.f));
          dpre_s[row * TH + col] = round_cd<T>(dg);
        }
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
    if constexpr (kSae) benc_s[l] = round_cd<T>(s);  // benc_s is free after the last step
  }
  if constexpr (kAct != Act::Relu) {  // the other per-latent sums, one at a time
#pragma unroll
    for (int q = 0; q < kNS; ++q) {
      __syncthreads();  // the previous sum is done with red_s
#pragma unroll
      for (int j = 0; j < 4; ++j) red_s[ty * TH + tx + 16 * j] = vs[q][j];
      __syncthreads();
      for (int l = tid; l < TH; l += kThreads) {
        float s = 0.f;
        for (int g = 0; g < 16; ++g) s += red_s[g * TH + l];  // fixed order
        if constexpr (kAct == Act::Jump) sae.act.dtheta[h0 + l] = s;
        else if (q == 0) sae.act.db_mag[h0 + l] = s;
        else if (q == 1) sae.act.dr_mag[h0 + l] = __fmul_rn(s, sae.act.er[h0 + l]);
        else benc_s[l] = round_cd<T>(s);  // Gated: the centring row reads round_T(sum dg)
      }
    }
  }
  if constexpr (kSae) {  // this block's row of db_dec's centring term
    __syncthreads();
    for (int k = tid; k < Cin; k += kThreads) {
      float s = 0.f;
      for (int l = 0; l < TH; ++l)
        s = fmaf(benc_s[l], to_f(w_enc[static_cast<long>(k) * H + h0 + l]), s);
      sae.db_cent[static_cast<long>(blockIdx.x) * Cin + k] = -s;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 pair on the tensor cores (header note: "bf16 (the training path)")
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kSwRow = 128;            // bytes per row of a 128-byte-swizzled tile (64 bf16)
constexpr int kBox = 64 * kSwRow;      // one TMA box [64 rows][64 columns] bf16: 8,192 bytes
constexpr int kWarps = kThreads / 32;  // 8: two warpgroups, each releasing a ring slot warp by warp

// forward, recon updated in place (any Cout)
constexpr int kFSt = 3;                // ring depth
constexpr int kTcFwdTT = 128;          // tokens per block
constexpr int kTcFwdSub = 128;         // latents per encode sub-tile, columns per decode chunk
constexpr int kTcFwdLG = 512;          // latents per group (round_bf16(post) held in shared memory)
constexpr int kFSlot = 4 * kBox;       // x [128][64] and W_enc [64][128]; W_dec [64][128] uses half

// forward, recon held in registers (Cout <= kHoldCout)
constexpr int kHSt = 4;                // ring depth
constexpr int kHoldTT = 64;            // tokens per block
constexpr int kHoldLG = 128;           // latents per group
constexpr int kHoldCout = 512;         // recon [64][512] f32: 128 registers a consumer thread
constexpr int kHSlot = 4 * kBox;       // x [64][64] + W_enc [64][128], or a W_dec tile
// the held width W (256 or 512): W_dec tiles of hold_ld(W) latents x W columns,
// 32 KB either way; the bf16 entry takes W = 256 where Cout <= 256
__host__ __device__ constexpr int hold_ld(int W) { return 128 * 128 / W; }

// backward
constexpr int kBSt = 4;                // ring depth
constexpr int kTcBwdTH = 64;           // latents per block
constexpr int kTcBwdTU = 128;          // tokens per phase-A sub-step
constexpr int kTcBwdTS = 512;          // tokens per step (post_s and dpre_s)
constexpr int kTcBwdCC = 128;          // channels per phase-B / phase-C chunk
constexpr int kBSlot = 3 * kBox;       // phase A: x or err [128][64] and a W tile [64][64]
// backward, gradient tiles held in registers (coder_bwd_held; the same ring,
// steps and sub-steps as coder_bwd_tc)
constexpr int kHeldCin = 256;          // dW_enc [256][64] f32: 64 registers a thread
constexpr int kHeldCout = 512;         // dW_dec [64][512] f32: 128 registers a thread
constexpr int kHeldMinCout = 256;      // at C_out <= 256 coder_bwd_tc is as fast (bwd_route)
constexpr int kHeldSets = 2;           // A-fragment sets of the register-A products
constexpr int kHeldSt = 4;             // ring depth
constexpr int kHeldSlot = 2 * kBox;    // x or err [128][64], or a box pair [64][128]
// backward, cluster pair (coder_bwd_pair): two CTAs share a latent block, E
// holding dW_enc and D dW_dec; each warpgroup runs every other sub-step of
// kPairTU tokens on its own ring, messages and barriers, trading post^T and the
// JumpReLU bits (E -> D) and dpre^T (D -> E) with the peer's warpgroup of the
// same parity, each a message of [64 latents][64 tokens] bf16 (a [64][64] box),
// E's with two words of bits a thread after it
constexpr int kPairCmax = 256;         // widest C: dW tile [256][64] f32, 128 registers a thread
constexpr int kPairTU = 64;            // tokens per sub-step
constexpr int kPairSt = 2;             // ring depth a warpgroup: token tiles [64][C]
constexpr int kPairLag = 1;            // sub-steps (a warpgroup's) E's encode runs ahead of dW_enc
constexpr int kPairRecv = 2;           // receive slots a warpgroup and direction
constexpr int kPairSlot = kPairCmax / 64 * kBox;      // a token tile: up to four [64][64] boxes
constexpr int kPairMsg = kBox + 8 * kThreads / 2;     // post^T and the bits: 9,216 bytes
// Act::Gated trades g^T in f32 (E -> D: a thread's 32 accumulators, one slot
// in D) and round_bf16(dg^T) (D -> E: a box, kPairRecv slots in E)
constexpr int kPairGMsg = 4 * 32 * kThreads / 2;     // g^T: 16,384 bytes
constexpr int kPairBars = 2 * kPairSt + 2 * kPairRecv + 2;  // mbarriers a warpgroup
// a warpgroup's buffers: its ring, then its receive slots and staging buffer
// (Act::Gated: 16 KB of receive slots, E's two dg^T boxes or D's one g^T, then
// 16 KB of E's g^T staging or D's dg^T staging and its round_bf16(enc^T) box)
__host__ __device__ constexpr int pair_part(Act a) {
  return kPairSt * kPairSlot + (a == Act::Gated ? 2 * kPairGMsg : (kPairRecv + 1) * kPairMsg);
}

// the leading 1,024 bytes leave room to align the swizzled tiles; the mbarriers
// (full and empty, one each per ring slot) come last
constexpr size_t fwd_tc_smem_bytes() {
  return 1024 + kFSt * kFSlot + 2 * kTcFwdLG * kTcFwdTT + sizeof(int) * kTcFwdTT + 16 * kFSt;
}
// posts: the [64][128] bf16 post blocks (2 for the gated two-output body)
constexpr size_t hold_smem_bytes(int posts = 1) {
  return 1024 + kHSt * kHSlot + posts * 2 * kHoldLG * kHoldTT + sizeof(int) * kHoldTT + 16 * kHSt;
}
// nv per-latent f32 vectors of the block's latents: 2 (b_enc, ct) for Act::Relu,
// 3 for the JumpReLU and gated epilogues
constexpr size_t bwd_tc_smem_bytes(int nv = 2) {
  return 1024 + kBSt * kBSlot + 2 * kTcBwdTS * kSwRow + nv * sizeof(float) * kTcBwdTH + 16 * kBSt;
}
// the ring, the resident W tiles (W_enc [kHeldCin][64], pass E also W_dec
// [64][kHeldCout], as [64][64] boxes), one [TS][64] bf16 buffer (round_bf16(dpre)
// or round_bf16(post)), b_enc, ct and the mbarriers (the ring's and the W tiles')
constexpr size_t held_smem_bytes(bool dec) {
  return 1024 + kHeldSt * kHeldSlot + (kHeldCin + (dec ? 0 : kHeldCout)) / 64 * kBox +
         kTcBwdTS * kSwRow + 2 * sizeof(float) * kTcBwdTH + 16 * kHeldSt + 8;
}
// per warpgroup its buffers (pair_part); the resident W tile (E: W_enc
// [C][64], D: W_dec [64][C], as [64][64] boxes); b_enc, theta and -theta/eps
// (Gated: b_gate, b_mag and exp(r_mag)); the mbarriers (per warpgroup the
// ring's, a receive slot's full and the peer slot's empty, staged and
// stage_free; the W tile's)
constexpr size_t pair_smem_bytes(Act a) {
  return 1024 + 2 * pair_part(a) + kPairCmax / 64 * kBox + 3 * sizeof(float) * kTcBwdTH +
         8 * (2 * kPairBars + 1);
}
static_assert(fwd_tc_smem_bytes() <= 232448 && hold_smem_bytes(2) <= 232448 &&
                  bwd_tc_smem_bytes(3) <= 232448 && held_smem_bytes(false) <= 232448 &&
                  pair_smem_bytes(Act::Jump) <= 232448 && pair_smem_bytes(Act::Relu) <= 232448 &&
                  pair_smem_bytes(Act::Gated) <= 232448,
              "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + (1024 - smem_u32(p) % 1024) % 1024;
}

// mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the barrier's phase ``parity`` has completed. A wait that lasts 10 s
// traps: a fault in a ring then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (bool first = true;; first = false) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (first) start = now;
    else if (now - start > 10000000000ull) __trap();
  }
}

// Thread block clusters (coder_bwd_pair): this CTA's rank, the shared::cluster
// address of ``p``'s place in CTA ``rank``'s shared memory, a barrier of every
// thread of the cluster, an arrival on a barrier of the peer. The arrival has
// the default semantics (release at CTA scope), as CUTLASS's consumers release a
// peer's slot: at release.cluster the pair runs slower (chip_bwd_probe.py's
// pair_release_cluster; PERF.md).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// ``bytes`` of this CTA's shared memory at src into the peer's at dst (both
// 16-byte aligned), counted on the peer's barrier bar (complete_tx)
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\ncp.async.bulk.commit_group;\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// wait until every bulk copy this thread issued has read its source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// TMA: box (col, row) of combo ``combo``'s matrix (blockIdx.y's by default) in
// ``map`` (rank 3: {cols, rows, combos}, innermost coordinate first; header
// note, "Combos") into shared memory at dst, its bytes counted on ``bar``;
// out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_box(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                        int col, int row, int combo = -1) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row),
      "r"(combo < 0 ? static_cast<int>(blockIdx.y) : combo)
      : "memory");
}

// The mbarriers of a ring of S slots: full[S] (one arrival, the issuing
// thread's expect_tx, plus the TMA bytes) and empty[S] (one arrival per warp).
template <int S>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The issuing side, run by one thread: acquire() waits until every warp has
// released the next slot, arms its full barrier for ``bytes`` and returns the
// slot; the caller then issues the TMA boxes on ``bar``.
template <int S>
struct Producer {
  unsigned char* ring;
  int slot_bytes;
  uint64_t* full;
  uint64_t* empty;
  int slot = 0;
  uint32_t phase = 0;
  uint64_t* bar = nullptr;

  __device__ __forceinline__ unsigned char* acquire(uint32_t bytes) {
    mbar_wait(&empty[slot], phase ^ 1);  // the first round passes: every slot starts free
    bar = &full[slot];
    mbar_expect_tx(bar, bytes);
    unsigned char* p = ring + slot * slot_bytes;
    if (++slot == S) slot = 0, phase ^= 1;
    return p;
  }
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy accesses to shared memory (st.shared, ld.shared) ordered with
// the async proxy's (wgmma reads, TMA writes)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consuming side, run by every warp: next() waits for the next
// tile; once its products are committed, issued() waits for the tile before
// (keep_one: this tile's products stay in flight; else for all) and releases
// that tile's slot. drain() waits for every product and releases the last
// slot; hold() does the same but keeps the last slot as scratch until
// release_held().
template <int S>
struct Consumer {
  unsigned char* ring;
  int slot_bytes;
  uint64_t* full;
  uint64_t* empty;
  int lane;
  int slot = 0;
  uint32_t phase = 0;
  int prev = -1;

  __device__ __forceinline__ unsigned char* next() {
    mbar_wait(&full[slot], phase);
    return ring + slot * slot_bytes;
  }
  __device__ __forceinline__ void release(int s) {
    if (s < 0) return;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  template <bool kKeepOne>
  __device__ __forceinline__ void issued() {
    if constexpr (kKeepOne) wg_wait<1>();
    else wg_wait<0>();
    release(prev);
    prev = slot;
    if (++slot == S) slot = 0, phase ^= 1;
  }
  __device__ __forceinline__ void drain() {
    wg_wait<0>();
    release(prev);
    prev = -1;
  }
  __device__ __forceinline__ unsigned char* hold() {
    wg_wait<0>();
    return ring + prev * slot_bytes;
  }
  __device__ __forceinline__ void release_held() {
    fence_async_smem();  // this thread's scratch accesses before the slot's next TMA write
    release(prev);
    prev = -1;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// byte offset of 16-byte chunk c (0-7) of row r in a 128-byte-swizzled tile (rows
// of 128 bytes, 8-row groups of 1,024 bytes on 1,024-byte boundaries): the
// layout TMA's SWIZZLE_128B writes and wgmma's descriptors below read
__device__ __forceinline__ uint32_t sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at smem address
// addr. Both stride fields are the 1,024 bytes between 8-row groups: the operands
// here are one 64-element swizzle row wide, so a K-major operand steps its 8-row
// groups along M/N and an MN-major one along K by the same amount.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define SVT_WG_D                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SVT_WG_D_OPS(d)                                                                        \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),    \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), \
      "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
      "+f"(d[7][2]), "+f"(d[7][3])

// One warpgroup: d[64 rows][64 columns] = A[64, 16] @ B[16, 64] (+ d when
// ``acc``), bf16 in, f32 accumulators; d[j][2h + e] is row 16*(warp in group) +
// lane/4 + 8h, column 8j + 2*(lane%4) + e. A and B in shared memory
// (descriptors); TA / TB 0 for a K-major operand, 1 for an MN-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_WG_D
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : SVT_WG_D_OPS(d)
      : "l"(da), "l"(db), "r"(static_cast<int>(acc)), "n"(TA), "n"(TB));
}

// The same with A in registers: each warp's 16 rows as an mma.m16n8k16 A fragment.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                         bool acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SVT_WG_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SVT_WG_D_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(static_cast<int>(acc)),
        "n"(TB));
}

// round_bf16(c * v) of both halves of a bf16 pair: drecon from the stored err
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float c) {
  __nv_bfloat162 h;
  memcpy(&h, &v, 4);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(c * f.x, c * f.y);
  memcpy(&v, &h, 4);
  return v;
}

// Read-modify-write of a warp's accumulators, pair by pair: the pair of
// acc[i][j][2h], acc[i][j][2h + 1] goes to at(i, h, j) (nullptr: past the width)
// as init(i, h, j) + acc when ``first``, else as the stored pair + acc. Every read is
// issued before the first write, so the reads overlap one another. A non-zero
// ``copy`` (floats) also writes each new pair that far from its place.
template <int MT, int NT, typename At, typename Init>
__device__ __forceinline__ void update_pairs(const float (&acc)[MT][NT][4], At at, Init init,
                                             bool first, long copy = 0) {
  float2 prev[MT][2][NT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2* o = at(i, h, j);
        prev[i][h][j] = first || o == nullptr ? init(i, h, j) : *o;
      }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (float2* o = at(i, h, j)) {
          const float2 v = make_float2(prev[i][h][j].x + acc[i][j][2 * h],
                                       prev[i][h][j].y + acc[i][j][2 * h + 1]);
          *o = v;
          if (copy) *reinterpret_cast<float2*>(reinterpret_cast<float*>(o) + copy) = v;
        }
}

// Statistics of one 64-latent column block of encode accumulators (acc[j][2h +
// e]: token ``tok0`` + 8h, latent column 8j + 2*(lane%4) + e, as wgmma_ss): post,
// round_bf16(post) into the 128-byte-swizzled K-major block ``post_blk`` (row
// ``tok0`` + 8h), per-token activity into rowc, and per-latent sums over the
// warp's 16 tokens into red_z / red_c[col] (lanes 0-3 write; the caller reduces
// over warps in a fixed order). kAct picks post (per-latent operands from af at
// latent lat + column):
//   Relu: post = max(pre, 0), counted where > 0, summed;
//   Jump: post = pre > theta ? pre : 0 (strict), counted where != 0, summed;
//   Gated: acc holds g = x_cent @ W_gate and b_enc is b_gate: pre_gate = g +
//     b_gate, pre_mag = g*er + b_mag (rounded apart, as the plain version),
//     gate 1 / 0.5 / 0 where pre_gate > / == / < 0; post = enc = gate *
//     relu(pre_mag), counted where != 0; relu_pi = relu(pre_gate) goes to
//     pi_blk as well and is what the per-latent sums add;
//   GatedEnc: enc and its counts only (no sums: red_z untouched);
//   GatedPi: relu_pi as post and its sums only (no counts: red_c, rowc untouched).
template <Act kAct>
__device__ __forceinline__ void post_epilogue(const float (&acc)[8][4], const float* b_enc,
                                              unsigned char* post_blk, int tok0, int lane,
                                              int (&rowc)[2], float* red_z, int* red_c,
                                              const ActFwd& af, int lat,
                                              unsigned char* pi_blk = nullptr) {
  constexpr bool kGate = kAct == Act::Gated || kAct == Act::GatedEnc || kAct == Act::GatedPi;
  constexpr bool kCount = kAct != Act::GatedPi, kSum = kAct != Act::GatedEnc;
  float zs[8][2];
  int cc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = j * 8 + 2 * (lane % 4);
      float p[2], q[2];  // post, and (Gated) relu_pi
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int on;
        if constexpr (kAct == Act::Relu) {
          p[e] = fmaxf(acc[j][2 * h + e] + b_enc[l + e], 0.f);
          on = p[e] > 0.f;
          q[e] = p[e];
        } else if constexpr (kAct == Act::Jump) {
          const float v = acc[j][2 * h + e] + b_enc[l + e];
          p[e] = v > af.theta[lat + l + e] ? v : 0.f;
          on = p[e] != 0.f;
          q[e] = p[e];
        } else {
          static_assert(kGate, "an epilogue of the forward");
          const float g = acc[j][2 * h + e], pg = g + b_enc[l + e];
          const float pm = __fadd_rn(__fmul_rn(g, af.er[lat + l + e]), af.b_mag[lat + l + e]);
          const float gate = pg > 0.f ? 1.f : (pg == 0.f ? 0.5f : 0.f);
          const float enc = __fmul_rn(gate, fmaxf(pm, 0.f));
          q[e] = fmaxf(pg, 0.f);
          p[e] = kAct == Act::GatedPi ? q[e] : enc;
          on = enc != 0.f;
        }
        if constexpr (kSum) zs[j][e] = h == 0 ? q[e] : zs[j][e] + q[e];
        if constexpr (kCount) {
          cc[j][e] = h == 0 ? on : cc[j][e] + on;
          rowc[h] += on;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(post_blk + sw128(tok0 + 8 * h, j) + (lane % 4) * 4) =
          __floats2bfloat162_rn(p[0], p[1]);
      if constexpr (kAct == Act::Gated)
        *reinterpret_cast<__nv_bfloat162*>(pi_blk + sw128(tok0 + 8 * h, j) + (lane % 4) * 4) =
            __floats2bfloat162_rn(q[0], q[1]);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {  // fixed order: the lanes of a column
        if constexpr (kSum) zs[j][e] += __shfl_xor_sync(0xffffffffu, zs[j][e], off);
        if constexpr (kCount) cc[j][e] += __shfl_xor_sync(0xffffffffu, cc[j][e], off);
      }
      if (lane < 4) {
        if constexpr (kSum) red_z[j * 8 + 2 * lane + e] = zs[j][e];
        if constexpr (kCount) red_c[j * 8 + 2 * lane + e] = cc[j][e];
      }
    }
}

// row_active of the block's tt tokens: each thread's counts for its two token
// rows (tok0, tok0 + 8) summed over the four lanes that share them, then over
// warps and warpgroups with integer atomics (exact, any order)
__device__ __forceinline__ void write_row_active(const int (&rowc)[2], int* rcnt_s, int tok0,
                                                 int lane, int tid, int tt, float* row_active) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int c = rowc[h];
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    if (lane % 4 == 0) atomicAdd(&rcnt_s[tok0 + 8 * h], c);
  }
  __syncthreads();
  if (tid < tt) row_active[tid] = static_cast<float>(rcnt_s[tid]);
}

// The dx route's pieces (kDx). pre > 0 of one 64-latent column block of encode
// accumulators (laid out as post_epilogue's; b_enc from the block's first
// latent), as bit 4j + 2h + e of acc[j][2h + e].
__device__ __forceinline__ uint32_t pre_mask(const float (&acc)[8][4], const float* b_enc,
                                             int lane) {
  uint32_t on = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      on |= static_cast<uint32_t>(acc[j][i] + b_enc[j * 8 + 2 * (lane % 4) + i % 2] > 0.f)
            << (4 * j + i);
  return on;
}

// dpre = pre > 0 ? dpost + c_l1 : 0 of the same block (acc: dpost; on:
// pre_mask's bits), round_bf16(dpre) into the K-major block ``blk`` at row tok0
// + 8h, where post_epilogue writes round_bf16(post)
__device__ __forceinline__ void dpre_epilogue(const float (&acc)[8][4], uint32_t on, float c_l1,
                                              unsigned char* blk, int tok0, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[e] = (on >> (4 * j + 2 * h + e)) & 1u ? acc[j][2 * h + e] + c_l1 : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(blk + sw128(tok0 + 8 * h, j) + (lane % 4) * 4) =
          __floats2bfloat162_rn(d[0], d[1]);
    }
}

// A fragments of round_bf16(c * err) for 4 k16 steps from a swizzled err tile,
// the warp's 16 rows from row0 (coder_bwd_tc's err_frags, untransposed)
__device__ __forceinline__ void scaled_frags(uint32_t (&a)[4][4], const unsigned char* tile,
                                             int row0, int lane, float c) {
  const int li = lane / 8, lr = lane % 8;  // ldmatrix: which 8x8 matrix, which row of it
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
    ldsm_x4(a[kk], reinterpret_cast<const bf16*>(
                       tile + sw128(row0 + lr + (li % 2) * 8, kk * 2 + li / 2)));
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = scale_pair(a[kk][r], c);
  }
}

// The same transposed: A's rows are the tile's columns col0 .. col0 + 15 (a
// multiple of 8), its k the tile's rows, 16 per k16 step (ldmatrix.trans; the
// A of coder_bwd_tc's phase C and coder_bwd_held's pass D)
__device__ __forceinline__ void scaled_frags_t(uint32_t (&a)[4][4], const unsigned char* tile,
                                               int col0, int lane, float c) {
  const int li = lane / 8, lr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm_x4_t(a[kk], reinterpret_cast<const bf16*>(
                         tile + sw128(kk * 16 + lr + (li / 2) * 8, col0 / 8 + li % 2)));
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = scale_pair(a[kk][r], c);
  }
}

// Forward, bf16, recon updated in place (Cout > kHoldCout: the crosscoder). One
// block owns kTcFwdTT = 128 tokens; its two consumer warpgroups each compute 64
// tokens' rows of every product with wgmma, 128 columns as two 64-wide halves;
// thread 0 streams the tiles by TMA (issue()), every tile 64 deep, in the order
// the warpgroups multiply them: per latent group [g0, group_end(g0)) (up to 512
// latents),
//   encode: per sub-tile s of 128 latents, per 64 channels: x [128][64] (K-major)
//           and W_enc [64][128] (MN-major, two 64-wide boxes);
//   decode: per 128-column chunk, per 64 latents: W_dec [64][128] (MN-major).
// round_bf16(post) of the group is the decode's A operand: post_s [128][512] as
// eight K-major [128][64] blocks. kPrefix: groups also end at every prefix
// boundary, and the decode of a group that ends one copies its updates of
// recon's last slice into that prefix's slice. Splits (header note): grid z
// sweeps its share [lo, hi) of the latent groups into its own partial of
// recon (kPrefix: then fills the slices of the prefixes that end outside it).
// kDx (recon is dx [T, C], updated in place as recon is; header note): groups
// end at every level boundary; after each encode sub-tile the stream adds, per
// 64 channels, err [128][64] (K-major, rows of the group's level) and W_dec
// [128][64] (K-major: dpost's B), and round_bf16(dpre) fills post_s; the
// decode's tiles become W_enc [128][64] (columns of the chunk, 64 latents;
// K-major B of dx += round_bf16(dpre) @ W_enc tile^T). The first group writes
// -c_rec * err_0 + acc.
template <bool kPrefix, Act kAct = Act::Relu, bool kDx = false>
__global__ void __launch_bounds__(kThreads, 1)
coder_fwd_tc(const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_we,
             const __grid_constant__ CUtensorMap m_wd, const float* __restrict__ b_enc,
             const float* __restrict__ b_dec, float* __restrict__ recon,
             float* __restrict__ act_part, float* __restrict__ row_active,
             float* __restrict__ zsum_part, int Cin, int Cout, int H, const svt::Levels lv,
             const __grid_constant__ TcFwd af) {
  constexpr int TT = kTcFwdTT, SUB = kTcFwdSub, LG = kTcFwdLG, KT = 64;
  constexpr bool kCount = kAct != Act::GatedPi, kSum = kAct != Act::GatedEnc;
  static_assert(kAct != Act::Gated && (kAct == Act::Relu || !kPrefix),
                "one output: the gated forward's wide route is two launches");
  static_assert(!kDx || (kAct == Act::Relu && !kPrefix), "dx: its levels come in lv");
  constexpr int kPostBlk = TT * kSwRow;  // a [128][64] block of post_s
  extern __shared__ __align__(1024) unsigned char tc_smem_fwd[];
  unsigned char* ring = align1024(tc_smem_fwd);
  unsigned char* post_s = ring + kFSt * kFSlot;                 // [LG / 64][TT][64]
  int* rcnt_s = reinterpret_cast<int*>(post_s + LG * TT * 2);  // [TT]
  uint64_t* full = reinterpret_cast<uint64_t*>(rcnt_s + TT);
  uint64_t* empty = full + kFSt;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * TT;
  const int nkc = (Cin + KT - 1) / KT, ncc = (Cout + SUB - 1) / SUB;
  const long slice = static_cast<long>(gridDim.x) * TT * Cout;  // one prefix's recon
  // combo blockIdx.y's recon of split blockIdx.z (header note, "Combos",
  // "Splits"), its last slice with kPrefix
  float* out = split_part(recon, (kPrefix ? lv.n : 1) * slice) + (kPrefix ? (lv.n - 1) * slice : 0);
  // this split's latents [lo, hi): its share of the 512-latent groups
  const int n_grp = (H + LG - 1) / LG, split = blockIdx.z, n_split = gridDim.z;
  const int lo = split * n_grp / n_split * LG, hi = min(H, (split + 1) * n_grp / n_split * LG);
  // Latent groups end at lo + skew + 512k: blocks start a quarter group apart,
  // so their in-place updates of recon do not all fall at the same moment.
  const int skew = static_cast<int>(blockIdx.x % 4) * SUB;
  auto group_end = [&](int g0) {
    const int e = min(hi, g0 < lo + skew ? lo + skew : g0 + LG);
    return kPrefix || kDx ? min(e, svt::level_end(lv, g0)) : e;
  };
  if (tid < TT) rcnt_s[tid] = 0;
  if (tid == 0) init_ring<kFSt>(full, empty);
  __syncthreads();

  // The tile stream, issued by thread 0 one tile at a time: the next tile goes
  // to the slot of the tile before the one just multiplied (kFSt - 1 tiles
  // ahead), so the issuing thread waits only for the warps still on that tile.
  const CUtensorMap *mx = &m_x, *mwe = &m_we, *mwd = &m_wd;  // param space
  [[maybe_unused]] const int n_tok = gridDim.x * TT;  // kDx: the rows of one level of err
  Producer<kFSt> prod{ring, kFSlot, full, empty};
  int p_g0 = lo, p_dec = 0, p_a = 0, p_k = 0;  // kDx: p_dec 2 is a sub-tile's dpost
  auto issue = [&]() {
    if (tid != 0 || p_g0 >= hi) return;
    const int nsub = (group_end(p_g0) - p_g0) / SUB;
    if constexpr (kDx) {
      if (p_dec == 2) {
        unsigned char* d = prod.acquire(4 * kBox);
        const int row = svt::level_of(lv, p_g0) * n_tok + t0;
        tma_box(d, &af.m_err, prod.bar, p_k * KT, row);
        tma_box(d + kBox, &af.m_err, prod.bar, p_k * KT, row + 64);
        tma_box(d + 2 * kBox, mwd, prod.bar, p_k * KT, p_g0 + p_a * SUB);
        tma_box(d + 3 * kBox, mwd, prod.bar, p_k * KT, p_g0 + p_a * SUB + 64);
        if (++p_k == nkc) {
          p_k = 0, p_dec = 0;
          if (++p_a == nsub) p_a = 0, p_dec = 1;
        }
        return;
      }
    }
    if (!p_dec) {
      unsigned char* d = prod.acquire(4 * kBox);
      tma_box(d, mx, prod.bar, p_k * KT, t0);
      tma_box(d + kBox, mx, prod.bar, p_k * KT, t0 + 64);
      tma_box(d + 2 * kBox, mwe, prod.bar, p_g0 + p_a * SUB, p_k * KT);
      tma_box(d + 3 * kBox, mwe, prod.bar, p_g0 + p_a * SUB + 64, p_k * KT);
      if (++p_k == nkc) {
        p_k = 0;
        if constexpr (kDx) p_dec = 2;
        else if (++p_a == nsub) p_a = 0, p_dec = 1;
      }
    } else {
      unsigned char* d = prod.acquire(2 * kBox);
      if constexpr (kDx) {  // W_enc [128 columns][64 latents]
        tma_box(d, mwe, prod.bar, p_g0 + p_k * KT, p_a * SUB);
        tma_box(d + kBox, mwe, prod.bar, p_g0 + p_k * KT, p_a * SUB + 64);
      } else {
        tma_box(d, mwd, prod.bar, p_a * SUB, p_g0 + p_k * KT);
        tma_box(d + kBox, mwd, prod.bar, p_a * SUB + 64, p_g0 + p_k * KT);
      }
      if (++p_k == nsub * SUB / KT) {
        p_k = 0;
        if (++p_a == ncc) p_a = 0, p_dec = 0, p_g0 = group_end(p_g0);
      }
    }
  };
  for (int i = 0; i < kFSt - 1; ++i) issue();
  const int wg = warp / 4, w4 = warp % 4;  // warpgroup, warp in it
  const int tok0 = wg * 64 + w4 * 16 + lane / 4;  // this thread's first token row
  Consumer<kFSt> c{ring, kFSlot, full, empty, lane};
  const uint32_t post_a = smem_u32(post_s);
  float acc[2][8][4];  // [64-column half][n8 block][fragment]
  int rowc[2] = {0, 0};
  [[maybe_unused]] float c_rec = 0.f, c_l1 = 0.f;  // kDx
  if constexpr (kDx) c_rec = af.coeffs[0], c_l1 = af.coeffs[1];
  for (int g0 = lo; g0 < hi; g0 = group_end(g0)) {
    const int nsub = (group_end(g0) - g0) / SUB;
    for (int s = 0; s < nsub; ++s) {
      for (int k = 0; k < nkc; ++k) {
        const uint32_t sa = smem_u32(c.next());
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            wgmma_ss<0, 1>(acc[nb], sw128_desc(sa + wg * kBox + kk * 32),
                           sw128_desc(sa + (2 + nb) * kBox + kk * 16 * kSwRow), k + kk > 0);
        wg_commit();
        c.issued<true>();
        issue();
      }
      if constexpr (kDx) {
        c.drain();
        uint32_t on[2];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          on[nb] = pre_mask(acc[nb], b_enc + g0 + s * SUB + nb * 64, lane);
        // dpost = round_bf16(c_rec * err) @ W_dec sub-tile^T, A from registers,
        // in accumulators of its own (header note, kDx)
        float dp[2][8][4];
        for (int k = 0; k < nkc; ++k) {
          const unsigned char* slot = c.next();
          uint32_t a[4][4];
          scaled_frags(a, slot, wg * 64 + w4 * 16, lane, c_rec);
          const uint32_t sa = smem_u32(slot);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              wgmma_rs<0>(dp[nb], a[kk], sw128_desc(sa + (2 + nb) * kBox + kk * 32), k + kk > 0);
          wg_commit();
          c.issued<false>();  // a is rewritten by the next tile
          issue();
        }
        // the warpgroup's own rows of post_s: its last reads of them are done
        c.drain();
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int lg = s * SUB + nb * 64;
          dpre_epilogue(dp[nb], on[nb], c_l1, post_s + (lg / 64) * kPostBlk, tok0, lane);
        }
        continue;
      }
      // The last tile's slot stays held: after the barrier (both warpgroups'
      // products done, the previous group's decode too) it holds the per-warp
      // partial sums of the statistics; round_bf16(post) goes to post_s.
      unsigned char* scratch = c.hold();
      __syncthreads();
      float* red_z = reinterpret_cast<float*>(scratch);  // [8 warps][SUB]
      int* red_c = reinterpret_cast<int*>(red_z + kWarps * SUB);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int lg = s * SUB + nb * 64;  // first latent of the half, within the group
        post_epilogue<kAct>(acc[nb], combo_part(b_enc, H) + g0 + lg,
                            post_s + (lg / 64) * kPostBlk, tok0, lane, rowc,
                            red_z + warp * SUB + nb * 64, red_c + warp * SUB + nb * 64, af.act,
                            static_cast<int>(blockIdx.y) * H + g0 + lg);
      }
      __syncthreads();
      {
        const int g = tid / SUB, l = tid % SUB;  // warpgroup g's 64 tokens, latent l
        float z = red_z[(4 * g) * SUB + l];
        int n = red_c[(4 * g) * SUB + l];
        for (int w = 1; w < 4; ++w) {  // fixed order
          z += red_z[(4 * g + w) * SUB + l];
          n += red_c[(4 * g + w) * SUB + l];
        }
        const long o =
            ((static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x) * 2 + g) * H + g0 + s * SUB + l;
        if constexpr (kCount) act_part[o] = static_cast<float>(n);
        if constexpr (kSum) zsum_part[o] = z;
      }
      c.release_held();
    }
    fence_async_smem();  // post_s, written by this thread, before wgmma reads it
    __syncthreads();

    // decode: recon[:, chunk] += round_bf16(post) @ W_dec[g0 : g0 + nsub*128, chunk]
    // (kDx: dx[:, chunk] += round_bf16(dpre) @ W_enc[chunk, g0 : g0 + nsub*128]^T)
    long snap = 0;  // kPrefix: floats from recon's last slice to the ending prefix's
    if constexpr (kPrefix)
      if (g0 + nsub * SUB < H && svt::ends_level(lv, g0 + nsub * SUB))
        snap = (svt::level_of(lv, g0) - (lv.n - 1)) * slice;
    for (int a = 0; a < ncc; ++a) {
      for (int k = 0; k < nsub * SUB / KT; ++k) {
        const uint32_t sa = smem_u32(c.next());
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            wgmma_ss<0, kDx ? 0 : 1>(
                acc[nb], sw128_desc(post_a + k * kPostBlk + wg * 64 * kSwRow + kk * 32),
                sw128_desc(sa + nb * kBox + kk * (kDx ? 32 : 16 * kSwRow)), k + kk > 0);
        wg_commit();
        c.issued<true>();
        issue();
      }
      c.drain();
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {  // one 64-column half at a time: fewer live registers
        const int c0 = a * SUB + nb * 64 + 2 * (lane % 4);
        update_pairs(
            reinterpret_cast<const float(&)[1][8][4]>(acc[nb]),
            [&](int, int h, int j) {
              return c0 + j * 8 < Cout ? reinterpret_cast<float2*>(
                                             out + static_cast<long>(t0 + tok0 + 8 * h) * Cout +
                                             c0 + j * 8)
                                       : nullptr;
            },
            [&](int, int h, int j) {
              const int col = c0 + j * 8;
              if constexpr (kDx) {  // -c_rec * err_0 (f32, not rounded)
                if (col >= Cout) return make_float2(0.f, 0.f);
                const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const bf16*>(af.err) +
                    static_cast<long>(t0 + tok0 + 8 * h) * Cout + col));
                return make_float2(-__fmul_rn(c_rec, v.x), -__fmul_rn(c_rec, v.y));
              } else {  // b_dec once: split 0's
                const float* bd = combo_part(b_dec, Cout);
                return col < Cout && split == 0 ? make_float2(bd[col], bd[col + 1])
                                                : make_float2(0.f, 0.f);
              }
            },
            g0 == lo, snap);
      }
    }
  }
  if constexpr (kPrefix) {
    if (n_split > 1) {  // the prefix slices that end outside [lo, hi) (header note, "Splits")
      __syncthreads();  // this block's updates of out are done
      for (int i = tid; i < TT * Cout; i += kThreads) {
        const long o = static_cast<long>(t0) * Cout + i;
        const float v = out[o];
#pragma unroll
        for (int p = 0; p < svt::kMaxLevels - 1; ++p)
          if (p < lv.n - 1 && (lv.end[p] <= lo || lv.end[p] > hi))
            out[(p - (lv.n - 1)) * slice + o] = lv.end[p] <= lo ? 0.f : v;
      }
    }
  }
  if constexpr (kCount && !kDx)
    write_row_active(rowc, rcnt_s, tok0, lane, tid, TT,
                     split_part(row_active, static_cast<long>(gridDim.x) * TT) + t0);
}

// Forward, bf16, recon held in registers (Cout <= W: the transcoder, the SAEs
// up to C = 512). One block owns kHoldTT = 64 tokens; its recon [64][W] f32
// stays in registers for the whole latent sweep (warpgroup g holds columns
// gW/2 .. gW/2 + W/2 - 1 as W/128 n64 accumulators) and is written once, and
// with kPrefix also at the end of each prefix's last group, into that prefix's
// slice. Per latent group of 128, thread 0 streams, every tile by TMA:
//   encode: per 64 channels, x [64][64] (K-major) and W_enc [64][128] (MN-major;
//           warpgroup g multiplies the 64 latents of box g);
//   decode: per LD = hold_ld(W) latents (32 or 64), W_dec [LD][W] (MN-major,
//           W/64 [LD][64] boxes; columns past Cout arrive as zeros).
// round_bf16(post) of the group, post_s [64][128] as two K-major [64][64]
// blocks (block g written by warpgroup g), is the decode's A operand.
// kDx (recon is dx [T, C], held as recon is; header note): per group the
// stream adds, after the encode, per 64 channels err [64][64] (K-major, rows of
// the group's level) and W_dec [128][64] (K-major: dpost's B); the decode's
// tiles become, per 64-column block nb of each warpgroup's half, W_enc [64][128]
// (K-major B of dx += round_bf16(dpre) @ W_enc tile^T; boxes 2g, 2g + 1 for
// warpgroup g).
template <int W, bool kPrefix, Act kAct = Act::Relu, bool kDx = false>
__global__ void __launch_bounds__(kThreads, 1)
coder_fwd_tc_hold(const __grid_constant__ CUtensorMap m_x,
                  const __grid_constant__ CUtensorMap m_we,
                  const __grid_constant__ CUtensorMap m_wd, const float* __restrict__ b_enc,
                  const float* __restrict__ b_dec, float* __restrict__ recon,
                  float* __restrict__ act_part, float* __restrict__ row_active,
                  float* __restrict__ zsum_part, int Cin, int Cout, int H,
                  const svt::Levels lv, const ActFwd af,
                  const __grid_constant__ DxFwd<kDx> dxf) {
  constexpr int TT = kHoldTT, LG = kHoldLG, LD = hold_ld(W), KT = 64;
  constexpr int NB = W / 128;            // n64 accumulators a warpgroup
  constexpr int kPostBlk = TT * kSwRow;  // a [64][64] block of post_s
  constexpr int kDecBox = LD * kSwRow;   // a [LD][64] box of W_dec
  constexpr bool kTwo = kAct == Act::Gated;  // recon and via held together
  constexpr bool kCount = kAct != Act::GatedPi, kSum = kAct != Act::GatedEnc;
  static_assert(2 * NB * kDecBox <= kHSlot, "W_dec tile");
  static_assert(!kTwo || W == 256, "two held outputs of 256 columns: hold<512>'s registers");
  static_assert(kAct == Act::Relu || !kPrefix, "the variants have no prefixes");
  static_assert(!kDx || (kAct == Act::Relu && !kPrefix), "dx: its levels come in lv");
  static_assert(!kDx || W == 256, "dx: 512 held columns beside dpost's accumulators spill");
  extern __shared__ __align__(1024) unsigned char tc_smem_hold[];
  unsigned char* ring = align1024(tc_smem_hold);
  unsigned char* post_s = ring + kHSt * kHSlot;  // [2][TT][64]
  unsigned char* pi_s = post_s + LG * TT * 2;    // kTwo: [2][TT][64] round_bf16(relu_pi)
  int* rcnt_s = reinterpret_cast<int*>(pi_s + (kTwo ? LG * TT * 2 : 0));  // [TT]
  uint64_t* full = reinterpret_cast<uint64_t*>(rcnt_s + TT);
  uint64_t* empty = full + kHSt;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * TT;
  const int nkc = (Cin + KT - 1) / KT;
  if (tid < TT) rcnt_s[tid] = 0;
  if (tid == 0) init_ring<kHSt>(full, empty);
  __syncthreads();

  // the tile stream, issued by thread 0 as coder_fwd_tc's
  const CUtensorMap *mx = &m_x, *mwe = &m_we, *mwd = &m_wd;  // param space
  // one combo's tokens (kDx: the rows of one level of err)
  const int n_tok = gridDim.x * TT;
  Producer<kHSt> prod{ring, kHSlot, full, empty};
  int p_g0 = 0, p_dec = 0, p_k = 0;
  auto issue = [&]() {
    if (tid != 0 || p_g0 >= H) return;
    if constexpr (kDx) {  // p_dec: 0 encode, 1 dpost, 2 the dx product
      if (p_dec == 2) {
        unsigned char* d = prod.acquire(4 * kBox);
#pragma unroll
        for (int b = 0; b < 4; ++b)  // warpgroup b / 2's channels, latents 64 * (b % 2) on
          tma_box(d + b * kBox, mwe, prod.bar, p_g0 + 64 * (b % 2), (b / 2) * (W / 2) + p_k * 64);
        if (++p_k == NB) p_k = 0, p_dec = 0, p_g0 += LG;
        return;
      }
      unsigned char* d = prod.acquire(3 * kBox);
      if (p_dec == 0) {
        tma_box(d, mx, prod.bar, p_k * KT, t0);
        tma_box(d + kBox, mwe, prod.bar, p_g0, p_k * KT);
        tma_box(d + 2 * kBox, mwe, prod.bar, p_g0 + 64, p_k * KT);
      } else {
        tma_box(d, &dxf.m_err, prod.bar, p_k * KT, svt::level_of(lv, p_g0) * n_tok + t0);
        tma_box(d + kBox, mwd, prod.bar, p_k * KT, p_g0);
        tma_box(d + 2 * kBox, mwd, prod.bar, p_k * KT, p_g0 + 64);
      }
      if (++p_k == nkc) p_k = 0, ++p_dec;
    } else if (!p_dec) {
      unsigned char* d = prod.acquire(3 * kBox);
      tma_box(d, mx, prod.bar, p_k * KT, t0);
      tma_box(d + kBox, mwe, prod.bar, p_g0, p_k * KT);
      tma_box(d + 2 * kBox, mwe, prod.bar, p_g0 + 64, p_k * KT);
      if (++p_k == nkc) p_k = 0, p_dec = 1;
    } else {
      unsigned char* d = prod.acquire(2 * NB * kDecBox);
#pragma unroll
      for (int b = 0; b < 2 * NB; ++b)
        tma_box(d + b * kDecBox, mwd, prod.bar, b * 64, p_g0 + p_k * LD);
      if (++p_k == LG / LD) p_k = 0, p_dec = 0, p_g0 += LG;
    }
  };
  for (int i = 0; i < kHSt - 1; ++i) issue();
  const int wg = warp / 4, w4 = warp % 4;
  const int tok0 = w4 * 16 + lane / 4;
  Consumer<kHSt> c{ring, kHSlot, full, empty, lane};
  const uint32_t post_a = smem_u32(post_s), pi_a = smem_u32(pi_s);
  float rec[NB][8][4];  // recon rows tok0 (+8), columns (W/2)*wg + 64*nb + ...
  [[maybe_unused]] float vi[kTwo ? NB : 1][8][4];  // kTwo: via_gate, as rec
  float acc[8][4];      // encode: the group's latents 64*wg .. 64*wg + 63
  int rowc[2] = {0, 0};
  [[maybe_unused]] float c_rec = 0.f, c_l1 = 0.f;  // kDx
  if constexpr (kDx) c_rec = dxf.coeffs[0], c_l1 = dxf.coeffs[1];
  // rec (kTwo: and vi) + b_dec into ``out`` (af.via) [T, Cout], once every product is done;
  // combo blockIdx.y's b_dec and via (header note, "Combos")
  auto store = [&](float* out) {
    c.drain();
    const float* bd = combo_part(b_dec, Cout);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wg * (W / 2) + nb * 64 + j * 8 + 2 * (lane % 4);
        if (col < Cout) {
          const float2 b = make_float2(bd[col], bd[col + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<float2*>(out + static_cast<long>(t0 + tok0 + 8 * h) * Cout + col) =
                make_float2(rec[nb][j][2 * h] + b.x, rec[nb][j][2 * h + 1] + b.y);
            if constexpr (kTwo)
              *reinterpret_cast<float2*>(combo_part(af.via, static_cast<long>(gridDim.x) * TT *
                                                                    Cout) +
                                         static_cast<long>(t0 + tok0 + 8 * h) * Cout + col) =
                  make_float2(vi[nb][j][2 * h] + b.x, vi[nb][j][2 * h + 1] + b.y);
          }
        }
      }
  };
  const long slice = static_cast<long>(gridDim.x) * TT * Cout;  // one prefix's recon
  for (int g0 = 0; g0 < H; g0 += LG) {
    for (int k = 0; k < nkc; ++k) {
      const uint32_t sa = smem_u32(c.next());
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 1>(acc, sw128_desc(sa + kk * 32),
                       sw128_desc(sa + (1 + wg) * kBox + kk * 16 * kSwRow), k + kk > 0);
      wg_commit();
      c.issued<true>();
      issue();
    }
    if constexpr (kDx) {
      c.drain();
      const uint32_t on = pre_mask(acc, b_enc + g0 + wg * 64, lane);
      // dpost = round_bf16(c_rec * err) @ W_dec tile^T, A from registers, in
      // accumulators of its own (header note, kDx)
      float dp[8][4];
      for (int k = 0; k < nkc; ++k) {
        const unsigned char* slot = c.next();
        uint32_t a[4][4];
        scaled_frags(a, slot, w4 * 16, lane, c_rec);
        const uint32_t s = smem_u32(slot);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<0>(dp, a[kk], sw128_desc(s + (1 + wg) * kBox + kk * 32), k + kk > 0);
        wg_commit();
        c.issued<false>();  // a is rewritten by the next tile
        issue();
      }
      c.drain();
      __syncthreads();  // both warpgroups' products of the last group are done with post_s
      dpre_epilogue(dp, on, c_l1, post_s + wg * kPostBlk, tok0, lane);
      fence_async_smem();  // post_s before wgmma reads it
      __syncthreads();
      // dx += round_bf16(dpre) @ W_enc[columns, g0 : g0 + 128]^T, per 64-column block
      // (unrolled: rec stays in registers)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint32_t sa = smem_u32(c.next());
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < LG / 16; ++kk)
          wgmma_ss<0, 0>(rec[nb], sw128_desc(post_a + (kk / 4) * kPostBlk + (kk % 4) * 32),
                         sw128_desc(sa + (2 * wg + kk / 4) * kBox + (kk % 4) * 32), g0 + kk > 0);
        wg_commit();
        c.issued<true>();
        issue();
      }
      continue;
    }
    // as coder_fwd_tc: the held slot takes the partial sums, post_s the post
    unsigned char* scratch = c.hold();
    __syncthreads();
    float* red_z = reinterpret_cast<float*>(scratch);  // [8 warps][64]
    int* red_c = reinterpret_cast<int*>(red_z + kWarps * 64);
    post_epilogue<kAct>(acc, combo_part(b_enc, H) + g0 + wg * 64, post_s + wg * kPostBlk, tok0,
                        lane, rowc, red_z + warp * 64, red_c + warp * 64, af,
                        static_cast<int>(blockIdx.y) * H + g0 + wg * 64, pi_s + wg * kPostBlk);
    fence_async_smem();  // post_s (and pi_s) before wgmma reads it
    __syncthreads();
    if (tid < LG) {  // latent tid of the group: warpgroup tid / 64's four warps, in order
      const int g = tid / 64, l = tid % 64;
      float z = red_z[(4 * g) * 64 + l];
      int n = red_c[(4 * g) * 64 + l];
      for (int w = 1; w < 4; ++w) {
        z += red_z[(4 * g + w) * 64 + l];
        n += red_c[(4 * g + w) * 64 + l];
      }
      const long o = (static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x) * H + g0 + tid;
      if constexpr (kCount) act_part[o] = static_cast<float>(n);
      if constexpr (kSum) zsum_part[o] = z;
    }
    c.release_held();

    // decode: rec += round_bf16(post) @ W_dec[g0 : g0 + 128, (W/2)*wg : (W/2)*(wg + 1)];
    // kTwo: vi += round_bf16(relu_pi) @ the same W_dec tile
    for (int k = 0; k < LG / LD; ++k) {
      const uint32_t sa = smem_u32(c.next());
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < LD / 16; ++kk) {
        const int lk = k * LD + kk * 16;  // latent within the group
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          wgmma_ss<0, 1>(rec[nb],
                         sw128_desc(post_a + (lk / 64) * kPostBlk + (lk % 64) * 2),
                         sw128_desc(sa + (NB * wg + nb) * kDecBox + kk * 16 * kSwRow),
                         g0 + k + kk > 0);
          if constexpr (kTwo)
            wgmma_ss<0, 1>(vi[nb], sw128_desc(pi_a + (lk / 64) * kPostBlk + (lk % 64) * 2),
                           sw128_desc(sa + (NB * wg + nb) * kDecBox + kk * 16 * kSwRow),
                           g0 + k + kk > 0);
        }
      }
      wg_commit();
      c.issued<true>();
      issue();
    }
    if constexpr (kPrefix)
      if (g0 + LG < H && svt::ends_level(lv, g0 + LG))
        store(combo_part(recon, lv.n * slice) + svt::level_of(lv, g0) * slice);
  }
  if constexpr (kDx) {  // dx - c_rec * err_0 (f32, not rounded) into recon, the dx output
    c.drain();
    const bf16* e = static_cast<const bf16*>(dxf.err);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wg * (W / 2) + nb * 64 + j * 8 + 2 * (lane % 4);
        if (col < Cout) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long o = static_cast<long>(t0 + tok0 + 8 * h) * Cout + col;
            const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e + o));
            *reinterpret_cast<float2*>(recon + o) =
                make_float2(rec[nb][j][2 * h] - __fmul_rn(c_rec, v.x),
                            rec[nb][j][2 * h + 1] - __fmul_rn(c_rec, v.y));
          }
        }
      }
  } else {
    store(combo_part(recon, (kPrefix ? lv.n : 1) * slice) + (kPrefix ? (lv.n - 1) * slice : 0));
    if constexpr (kCount)
      write_row_active(rowc, rcnt_s, tok0, lane, tid, TT, combo_part(row_active, n_tok) + t0);
  }
}

// Column sums of a warp's rows, scattered over its lanes: v[j][e] is this
// thread's part of column 8j + 2*(lane%4) + e (the accumulator layout of
// wgmma_ss), and the eight lanes that share lane % 4 add theirs by recursive
// halving (14 shuffles, in a fixed order), each lane keeping the half its
// lane bits pick, so lane ends with the warp's sums of columns 2*lane + e
// (8*(lane/4) + 2*(lane%4) + e), which it adds into acc[e].
__device__ __forceinline__ void warp_col_sums(float (&acc)[2], const float (&v)[8][2], int lane) {
  const bool k4 = lane & 16, k2 = lane & 8, k1 = lane & 4;  // keep the upper half
  float a[4][2], b[2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      a[i][e] = (k4 ? v[i + 4][e] : v[i][e]) +
                __shfl_xor_sync(0xffffffffu, k4 ? v[i][e] : v[i + 4][e], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      b[i][e] = (k2 ? a[i + 2][e] : a[i][e]) +
                __shfl_xor_sync(0xffffffffu, k2 ? a[i][e] : a[i + 2][e], 8);
#pragma unroll
  for (int e = 0; e < 2; ++e)
    acc[e] += (k1 ? b[1][e] : b[0][e]) + __shfl_xor_sync(0xffffffffu, k1 ? b[0][e] : b[1][e], 4);
}

constexpr int kSplitSums = 4;  // per-latent sums a backward split leaves (Gated's four)

// A coder_bwd_tc block's latent block, combo and split. The launch grid is (H /
// 64, N, s), its blocks numbered so that a latent block's s splits are
// neighbours in launch order: they run together, so the last one's sum reads
// the others' partials from L2 and the sums spread over the launch (with the
// splits outermost, all of them fell in its last waves: 8% slower than unsplit
// at N 8, PERF.md). Without a split, (blockIdx.x, blockIdx.y, 0).
struct BwdBlock {
  int x, combo, split;
};
__device__ __forceinline__ BwdBlock bwd_block() {
  const int s = gridDim.z, gx = gridDim.x;
  const int i = blockIdx.x + gx * (blockIdx.y + gridDim.y * blockIdx.z);
  return {i / s % gx, i / s / gx, i % s};
}

// Split b.split's partial of combo b.combo's gradient (``size`` floats a combo;
// header note, "Splits"): split 0's is the output itself, split z >= 1's lies at
// ws [s - 1][N][size].
__device__ __forceinline__ float* split_dw(float* out, float* ws, long size, const BwdBlock& b) {
  return b.split == 0 ? combo_part(out, size, b.combo)
                      : ws + (static_cast<long>(b.split - 1) * gridDim.y + b.combo) * size;
}

// The last split's sum of a latent block's gradient tile: ``rows`` rows of
// ``cols`` floats (a multiple of 4), ``stride`` floats apart, at ``out`` (split
// 0's partial, the output) and at part + (z - 1) * part_stride (split z >= 1's),
// added in split order into out, U float4 of a thread in flight a partial
// (the splits ran side by side: the partials come from L2, and the pass is
// bound by the loads in flight).
__device__ __forceinline__ void add_split_tiles(float* out, const float* part, long part_stride,
                                                int rows, long stride, int cols) {
  constexpr int U = 8;
  const int per_row = cols / 4, n = rows * per_row, n_split = gridDim.z;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * kThreads) {
    float4 v[U], w[U];
    long o[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      o[u] = static_cast<long>(i / per_row) * stride + (i % per_row) * 4;
      if (i < n) v[u] = __ldcg(reinterpret_cast<const float4*>(out + o[u]));
    }
    for (int z = 1; z < n_split; ++z) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * kThreads < n)
          w[u] = __ldcg(reinterpret_cast<const float4*>(part + (z - 1) * part_stride + o[u]));
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u].x += w[u].x, v[u].y += w[u].y, v[u].z += w[u].z, v[u].w += w[u].w;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * kThreads < n) *reinterpret_cast<float4*>(out + o[u]) = v[u];
  }
}

// Every thread's writes fenced, thread 0 draws ``ticket`` (an int the caller
// zeroed, one a latent block); true in the split that draws the last one,
// false in the others (every thread of a block alike). ``flag`` is an int of
// shared memory.
__device__ __forceinline__ bool last_ticket(int* ticket, int* flag) {
  __threadfence();  // this thread's writes before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(ticket, 1) == static_cast<int>(gridDim.z) - 1;
    __threadfence();  // the ticket before the other splits' writes are read
  }
  __syncthreads();
  return *flag;
}

// Where coder_bwd_tc's splits meet (header note, "Splits"). Threads tid < 64
// hold this split's per-latent sums s[0..kN) of latents h0 + tid; they go to
// this split's rows of ws [s][N][kSplitSums][H] f32, then every thread's
// writes (the gradient partials' too) are fenced and thread 0 draws a ticket
// of the latent block (the ints after the rows, [N][H / 64]). The split that
// draws the last ticket returns true, with s[q] the sums of every split added
// in split order; the others return false (every thread of a block alike).
// ``flag`` is an int of shared memory; ``gx`` the latent blocks of one
// dictionary where the grid's x is not (coder_bwd_pair: two CTAs a block).
template <int kN>
__device__ __forceinline__ bool last_split(float (&s)[kN], float* ws, int H, const BwdBlock& b,
                                           int* flag, int gx = 0) {
  const int tid = threadIdx.x, h0 = b.x * kTcBwdTH;
  const long n = gridDim.y, rows = static_cast<long>(gridDim.z) * n * kSplitSums * H;
  auto at = [&](long split, int q) {
    return ws + ((split * n + b.combo) * kSplitSums + q) * H + h0 + tid;
  };
  if (tid < kTcBwdTH)
#pragma unroll
    for (int q = 0; q < kN; ++q) *at(b.split, q) = s[q];
  if (!last_ticket(reinterpret_cast<int*>(ws + rows) + b.combo * (gx ? gx : gridDim.x) + b.x,
                   flag))
    return false;
  if (tid < kTcBwdTH)
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      float v = __ldcg(at(0, q));
      for (int split = 1; split < static_cast<int>(gridDim.z); ++split) v += __ldcg(at(split, q));
      s[q] = v;
    }
  return true;
}

// Backward, bf16. One block owns kTcBwdTH = 64 latents and sweeps the tokens in
// steps of kTcBwdTS = 512; its two warpgroups each compute a 64 x 64 piece of
// every product with wgmma, and thread 0 streams the tiles by TMA (issue()),
// per step (every tile 64 deep):
//   A. per 128 tokens: per 64 channels of Cin, x [128][64] and W_enc [64][64];
//      then per 64 channels of Cout, err [128][64] and W_dec [64][64];
//   B. per 128 input channels, per 64 tokens: x [64][128];
//   C. per 128 output columns, per 64 tokens: err [64][128].
// Phase A computes pre = x @ W_enc (both operands from shared memory) and dpost
// = round_bf16(c_rec*err) @ W_dec^T (A from registers: ldmatrix, scaled and
// rounded), per warpgroup 64 tokens; round_bf16(post) and round_bf16(dpre) go to
// post_s and dpre_s [512][64] (swizzled, MN-major operands of B and C). Phase B:
// dW_enc[chunk] = x^T @ dpre_s, per warpgroup 64 channels (x MN-major). Phase C:
// dW_dec[:, chunk]^T = round_bf16(c_rec*err)^T @ post_s, per warpgroup 64
// columns (A from registers, ldmatrix.trans). The first step writes dW_enc and
// dW_dec, later steps add to them. Step si's db_dec partial (row si of
// db_dec_part) is summed in phase C by block si % n_own from the err tiles it
// already holds: n_own = gridDim.x, or with kSae the blocks of level 0, whose
// err tiles are S_0's (m_err then maps [P*T, Cout], a block of level q reading
// rows q*T on).
//
// kAct Jump and Gated (kSae, one level, Cin = Cout = C): err arrives already
// scaled, round_bf16(c * err) from scale_err_kernel, so the body reads it as it
// is (a unit scale) and sums no direct db_dec rows (the pre-pass wrote them).
//   Jump: round_bf16(post) with post = pre > theta ? pre : 0, dpre = pre >
//     theta ? dpost : 0 (no L1 cotangent), and per latent dtheta = sum_t win *
//     (dpost * (-theta/eps) + c_l0 * (-1/eps)), win = |pre - theta| <= eps/2.
//   Gated: phase A runs three products per 128 tokens, g = x_cent @ W_gate
//     tile, denc = drecon @ W_dec tile^T, then (m_err rows T on, the scaled
//     via error) dvia @ W_dec tile^T + c_l1 = d_relu_pi, with the epilogue
//     split around the third: post_s takes round_bf16(enc), dpre_s
//     round_bf16(dg); phase B gives dW_gate, phase C dW_dec from enc.
// Their per-latent sums (db_enc / db_gate, dtheta; db_mag, sum d_premag * g,
// sum dg) leave each 128-token sub-step's registers at once (warp_col_sums),
// two floats a thread each, and meet over the warps after the last step.
// Splits (header note): grid z sweeps its share of the steps into its partials
// of dW_enc and dW_dec (split_dw); its per-latent sums meet the other splits'
// in split_ws (last_split), and the last split of a latent block adds the
// other splits' gradient tiles into the outputs and writes the rest.
template <bool kSae, Act kAct = Act::Relu>
__global__ void __launch_bounds__(kThreads, 1)
coder_bwd_tc(const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_we,
             const __grid_constant__ CUtensorMap m_wd, const __grid_constant__ CUtensorMap m_err,
             const float* __restrict__ b_enc, const float* __restrict__ coeffs,
             const float* __restrict__ ct, float* __restrict__ dw_enc,
             float* __restrict__ db_enc, float* __restrict__ dw_dec,
             float* __restrict__ db_dec_part, int n_tokens, int Cin, int Cout, int H,
             const SaeBwd sae, float* __restrict__ split_ws) {
  constexpr int TH = kTcBwdTH, TU = kTcBwdTU, TS = kTcBwdTS, CC = kTcBwdCC, KT = 64;
  constexpr bool kVar = kAct != Act::Relu;  // err pre-scaled; per-latent sums per sub-step
  static_assert(kSae || !kVar, "the JumpReLU and gated epilogues are the SAEs'");
  constexpr int kNV = kVar ? 3 : 2;  // per-latent vectors in shared memory
  constexpr int kErrPasses = kAct == Act::Gated ? 2 : 1;  // error products in phase A
  extern __shared__ __align__(1024) unsigned char tc_smem_bwd[];
  unsigned char* ring = align1024(tc_smem_bwd);
  unsigned char* post_s = ring + kBSt * kBSlot;  // [TS][64] round_bf16(post)
  unsigned char* dpre_s = post_s + TS * kSwRow;  // [TS][64] round_bf16(dpre)
  float* benc_s = reinterpret_cast<float*>(dpre_s + TS * kSwRow);  // [TH] b_enc; Gated: b_gate
  float* ct_s = benc_s + TH;  // [TH] ct; Jump: theta; Gated: b_mag
  float* v2_s = ct_s + TH;    // [TH] kVar: Jump -theta/eps, Gated exp(r_mag)
  uint64_t* full = reinterpret_cast<uint64_t*>(benc_s + kNV * TH);
  uint64_t* empty = full + kBSt;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const BwdBlock blk = bwd_block();  // latent block, combo, split
  const int h0 = blk.x * TH, cb = blk.combo;
  const int nki = (Cin + KT - 1) / KT, nko = (Cout + KT - 1) / KT;
  const int nci = (Cin + CC - 1) / CC, nco = (Cout + CC - 1) / CC;
  const int qrow = kSae ? svt::level_of(sae.lv, h0) * n_tokens : 0;  // this level's err rows
  const int n_own = kSae ? sae.lv.end[0] / TH : 0;  // kSae: the level-0 blocks
  // this split's tokens [t_lo, t_hi): its share of the steps (header note, "Splits")
  const int n_steps = (n_tokens + TS - 1) / TS, split = blk.split, n_split = gridDim.z;
  const int t_lo = split * n_steps / n_split * TS;
  const int t_hi = min(n_tokens, (split + 1) * n_steps / n_split * TS);
  // combo cb's pointer operands, each moved where it is used (header
  // note, "Combos"): coeffs by kCoef floats, the per-latent ones by H, the
  // gradients by theirs, db_dec_part (its direct rows, then with kSae the H / 64
  // centring rows that sae.db_cent points into) by ``part``
  constexpr int kCoef = kAct == Act::Gated ? 3 : 2;
  const long part = static_cast<long>((n_tokens + TS - 1) / TS) * Cout +
                    (kSae ? static_cast<long>(H / TH) * Cin : 0);
  if (tid < TH) {
    benc_s[tid] = combo_part(b_enc, H, cb)[h0 + tid];
    if constexpr (kAct == Act::Relu) {
      ct_s[tid] = combo_part(ct, H, cb)[h0 + tid];
    } else if constexpr (kAct == Act::Jump) {
      const float th = combo_part(sae.act.theta, H, cb)[h0 + tid];
      ct_s[tid] = th;
      v2_s[tid] = __fdiv_rn(-th, sae.act.eps);
    } else {
      ct_s[tid] = combo_part(sae.act.b_mag, H, cb)[h0 + tid];
      v2_s[tid] = combo_part(sae.act.er, H, cb)[h0 + tid];
    }
  }
  if (tid == 0) init_ring<kBSt>(full, empty);
  __syncthreads();

  // the tile stream, issued by thread 0 as coder_fwd_tc's
  const CUtensorMap *mx = &m_x, *mwe = &m_we, *mwd = &m_wd, *merr = &m_err;  // param space
  Producer<kBSt> prod{ring, kBSlot, full, empty};
  int p_t = t_lo, p_ph = 0, p_a = 0, p_k = 0;
  auto issue = [&]() {
    if (tid != 0 || p_t >= t_hi) return;
    const int ntok = min(TS, n_tokens - p_t);
    if (p_ph == 0) {  // A
      const int r0 = p_t + p_a * TU;
      unsigned char* d = prod.acquire(3 * kBox);
      if (p_k < nki) {
        tma_box(d, mx, prod.bar, p_k * KT, r0, cb);
        tma_box(d + kBox, mx, prod.bar, p_k * KT, r0 + 64, cb);
        tma_box(d + 2 * kBox, mwe, prod.bar, h0, p_k * KT, cb);
      } else {
        int k0 = (p_k - nki) * KT, row = qrow + r0;
        if constexpr (kAct == Act::Gated)
          if (p_k >= nki + nko) k0 -= nko * KT, row += n_tokens;  // the via error's pass
        tma_box(d, merr, prod.bar, k0, row, cb);
        tma_box(d + kBox, merr, prod.bar, k0, row + 64, cb);
        tma_box(d + 2 * kBox, mwd, prod.bar, k0, h0, cb);
      }
      if (++p_k == nki + kErrPasses * nko) {
        p_k = 0;
        if (++p_a == ntok / TU) p_a = 0, p_ph = 1;
      }
    } else {  // B (x) or C (err)
      const bool b = p_ph == 1;
      unsigned char* d = prod.acquire(2 * kBox);
      const int r = p_t + p_k * KT;
      if (b) {  // a branch, not a select of the two maps: nvcc 12.8's cicc crashes on that
        tma_box(d, mx, prod.bar, p_a * CC, r, cb);
        tma_box(d + kBox, mx, prod.bar, p_a * CC + 64, r, cb);
      } else {
        tma_box(d, merr, prod.bar, p_a * CC, qrow + r, cb);
        tma_box(d + kBox, merr, prod.bar, p_a * CC + 64, qrow + r, cb);
      }
      if (++p_k == ntok / KT) {
        p_k = 0;
        if (++p_a == (b ? nci : nco)) {
          p_a = 0;
          if (++p_ph == 3) p_ph = 0, p_t += TS;
        }
      }
    }
  };
  for (int i = 0; i < kBSt - 1; ++i) issue();
  const int wg = warp / 4, w4 = warp % 4;  // warpgroup, warp in it
  const int li = lane / 8, lr = lane % 8;  // ldmatrix: which 8x8 matrix, which row of it
  const float c_rec = combo_part(coeffs, kCoef, cb)[0];
  Consumer<kBSt> c{ring, kBSlot, full, empty, lane};

  // A fragments of round_bf16(c_rec * err) from a swizzled err tile, 4 k16 steps:
  // rows (A's M) along the tile's rows (tr false) or along its columns (tr true)
  auto err_frags = [&](uint32_t (&af)[4][4], const unsigned char* tile, bool tr) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
      if (tr)
        ldsm_x4_t(af[kk], reinterpret_cast<const bf16*>(
                              tile + sw128(kk * 16 + lr + (li / 2) * 8, w4 * 2 + li % 2)));
      else
        ldsm_x4(af[kk], reinterpret_cast<const bf16*>(
                            tile + sw128(wg * 64 + w4 * 16 + lr + (li % 2) * 8, kk * 2 + li / 2)));
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if constexpr (!kVar) af[kk][r] = scale_pair(af[kk][r], c_rec);
    }
  };
  // d = (the next nko err tiles, A from registers) @ W_dec tile^T
  auto err_product = [&](float (&d)[8][4]) {
    for (int k = 0; k < nko; ++k) {
      const unsigned char* slot = c.next();
      uint32_t af[4][4];
      err_frags(af, slot, false);
      const uint32_t s = smem_u32(slot);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(d, af[kk], sw128_desc(s + 2 * kBox + kk * 32), k + kk > 0);
      wg_commit();
      c.issued<false>();  // af is rewritten by the next tile
      issue();
    }
    c.drain();
  };

  const uint32_t post_a = smem_u32(post_s), dpre_a = smem_u32(dpre_s);
  float gbe[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) gbe[j][0] = gbe[j][1] = 0.f;
  // kVar: the per-latent sums (Jump: dpre, dtheta terms; Gated: d_pregate,
  // d_premag, d_premag * g, dg) of columns 8*(lane/4) + 2*(lane%4) + e over the
  // warp's rows (warp_col_sums)
  constexpr int kNS = kAct == Act::Gated ? 4 : 2;
  float vs[kNS][2];
#pragma unroll
  for (int q = 0; q < kNS; ++q) vs[q][0] = vs[q][1] = 0.f;
  // Jump: c_l0 * (-1/eps); Gated: c_l1
  const float c_1 = kAct == Act::Jump ? __fmul_rn(combo_part(coeffs, kCoef, cb)[1], sae.act.neg_inv_eps)
                                      : kVar ? combo_part(coeffs, kCoef, cb)[1] : 0.f;

  for (int t = t_lo, si = t_lo / TS; t < t_hi; t += TS, ++si) {
    const int ntok = min(TS, n_tokens - t);
    const bool first = t == t_lo;

    // A. pre = x @ W_enc tile + b_enc, dpost = round_bf16(c_rec*err) @ W_dec tile^T
    for (int u = 0; u < ntok / TU; ++u) {
      float pre[8][4], dp[8][4];
      for (int k = 0; k < nki; ++k) {
        const uint32_t s = smem_u32(c.next());
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 1>(pre, sw128_desc(s + wg * kBox + kk * 32),
                         sw128_desc(s + 2 * kBox + kk * 16 * kSwRow), k + kk > 0);
        wg_commit();
        c.issued<true>();
        issue();
      }
      err_product(dp);
      __syncthreads();  // phases B and C of the last step are done with post_s, dpre_s
      const int tok0 = u * TU + wg * 64 + w4 * 16 + lane / 4;  // this thread's first row
      if constexpr (kAct == Act::Relu) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = j * 8 + 2 * (lane % 4);
            float p[2], d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              p[e] = pre[j][2 * h + e] + benc_s[l + e];
              d[e] = p[e] > 0.f ? dp[j][2 * h + e] + ct_s[l + e] : 0.f;
              gbe[j][e] += d[e];
            }
            const uint32_t o = sw128(tok0 + 8 * h, j) + (lane % 4) * 4;
            *reinterpret_cast<__nv_bfloat162*>(post_s + o) =
                __floats2bfloat162_rn(fmaxf(p[0], 0.f), fmaxf(p[1], 0.f));
            *reinterpret_cast<__nv_bfloat162*>(dpre_s + o) = __floats2bfloat162_rn(d[0], d[1]);
          }
      } else if constexpr (kAct == Act::Jump) {
        float sb[8][2], st[8][2];  // this thread's two rows' dpre and dtheta terms
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = j * 8 + 2 * (lane % 4);
            float p[2], d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = pre[j][2 * h + e] + benc_s[l + e], th = ct_s[l + e];
              const float dpost = dp[j][2 * h + e];
              const bool on = v > th;
              const float w = fabsf(v - th) <= sae.act.half_eps
                                  ? __fadd_rn(__fmul_rn(dpost, v2_s[l + e]), c_1)
                                  : 0.f;
              p[e] = on ? v : 0.f;
              d[e] = on ? dpost : 0.f;
              sb[j][e] = h ? sb[j][e] + d[e] : d[e];
              st[j][e] = h ? st[j][e] + w : w;
            }
            const uint32_t o = sw128(tok0 + 8 * h, j) + (lane % 4) * 4;
            *reinterpret_cast<__nv_bfloat162*>(post_s + o) = __floats2bfloat162_rn(p[0], p[1]);
            *reinterpret_cast<__nv_bfloat162*>(dpre_s + o) = __floats2bfloat162_rn(d[0], d[1]);
          }
        warp_col_sums(vs[0], sb, lane);
        warp_col_sums(vs[1], st, lane);
      } else {
        // pre holds g, dp denc. First enc into post_s, d_premag's sums, and
        // d_premag * er (dg's first term) in place of denc; g's mask bits
        // pre_gate > 0 stay for the second part.
        uint32_t pos = 0;  // bit 4j + 2h + e
        float sm[8][2], smg[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = j * 8 + 2 * (lane % 4);
            float en[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * h + e;
              const float g = pre[j][i], er = v2_s[l + e];
              const float pg = g + benc_s[l + e];
              const float pm = __fadd_rn(__fmul_rn(g, er), ct_s[l + e]);  // as the plain version
              const float gate = pg > 0.f ? 1.f : (pg == 0.f ? 0.5f : 0.f);
              const float dm = pm > 0.f ? __fmul_rn(dp[j][i], gate) : 0.f;
              const float dmg = __fmul_rn(dm, g);
              en[e] = gate * fmaxf(pm, 0.f);
              sm[j][e] = h ? sm[j][e] + dm : dm;
              smg[j][e] = h ? smg[j][e] + dmg : dmg;
              dp[j][i] = __fmul_rn(dm, er);
              pos |= static_cast<uint32_t>(pg > 0.f) << (4 * j + i);
            }
            *reinterpret_cast<__nv_bfloat162*>(post_s + sw128(tok0 + 8 * h, j) + (lane % 4) * 4) =
                __floats2bfloat162_rn(en[0], en[1]);
          }
        warp_col_sums(vs[1], sm, lane);
        warp_col_sums(vs[2], smg, lane);
        // then d_relu_pi = dvia @ W_dec tile^T + c_l1 into pre, d_pregate, dg
        err_product(pre);
        float sg[8][2], sdg[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * h + e;
              const float dpg = (pos >> (4 * j + i)) & 1u ? pre[j][i] + c_1 : 0.f;
              d[e] = __fadd_rn(dp[j][i], dpg);
              sg[j][e] = h ? sg[j][e] + dpg : dpg;
              sdg[j][e] = h ? sdg[j][e] + d[e] : d[e];
            }
            *reinterpret_cast<__nv_bfloat162*>(dpre_s + sw128(tok0 + 8 * h, j) + (lane % 4) * 4) =
                __floats2bfloat162_rn(d[0], d[1]);
          }
        warp_col_sums(vs[0], sg, lane);
        warp_col_sums(vs[3], sdg, lane);
      }
    }
    fence_async_smem();  // post_s and dpre_s before wgmma reads them
    __syncthreads();

    // B. dW_enc[chunk, tile] += x[:, chunk]^T @ round_bf16(dpre) over the step's tokens
    for (int ci = 0; ci < nci; ++ci) {
      float g[8][4];
      for (int k = 0; k < ntok / KT; ++k) {
        const uint32_t s = smem_u32(c.next());
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(g, sw128_desc(s + wg * kBox + kk * 16 * kSwRow),
                         sw128_desc(dpre_a + (k * KT + kk * 16) * kSwRow), k + kk > 0);
        wg_commit();
        c.issued<true>();
        issue();
      }
      c.drain();
      update_pairs(
          reinterpret_cast<const float(&)[1][8][4]>(g),
          [&](int, int h, int j) {
            const int ch = ci * CC + wg * 64 + w4 * 16 + lane / 4 + 8 * h;
            return ch < Cin ? reinterpret_cast<float2*>(
                                  split_dw(dw_enc, split_ws, static_cast<long>(Cin) * H, blk) +
                                  static_cast<long>(ch) * H + h0 + j * 8 + 2 * (lane % 4))
                            : nullptr;
          },
          [](int, int, int) { return make_float2(0.f, 0.f); }, first);
    }

    // C. dW_dec[tile, chunk] += round_bf16(post)^T @ round_bf16(c_rec*err[:, chunk]),
    // computed transposed: round_bf16(c_rec*err[:, chunk])^T @ round_bf16(post)
    const bool own_db = !kVar && si % (kSae ? n_own : static_cast<int>(gridDim.x)) == blk.x;
    for (int ci = 0; ci < nco; ++ci) {
      float g[8][4];
      float dd = 0.f;  // own_db: column ci*CC + tid of db_dec over the step (tid < CC)
      for (int k = 0; k < ntok / KT; ++k) {
        const unsigned char* slot = c.next();
        uint32_t af[4][4];
        err_frags(af, slot + wg * kBox, true);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(g, af[kk], sw128_desc(post_a + (k * KT + kk * 16) * kSwRow), k + kk > 0);
        wg_commit();
        if (own_db && tid < CC) {
          const unsigned char* col = slot + (tid / 64) * kBox + (tid % 8) * 2;
          for (int r = 0; r < KT; ++r)
            dd += c_rec * __bfloat162float(
                              *reinterpret_cast<const bf16*>(col + sw128(r, (tid % 64) / 8)));
        }
        c.issued<false>();
        issue();
      }
      c.drain();
      // g[j][2h + e]: output column ci*CC + wg*64 + w4*16 + lane/4 + 8h, latent
      // h0 + 8j + 2*(lane%4) + e; every read before the first write
      const int col = ci * CC + wg * 64 + w4 * 16 + lane / 4;
      float* const dwd = split_dw(
          dw_dec, split_ws + static_cast<long>(n_split - 1) * gridDim.y * Cin * H,
          static_cast<long>(H) * Cout, blk);
      float prev[8][2][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long o = static_cast<long>(h0 + j * 8 + 2 * (lane % 4) + e) * Cout + col + 8 * h;
            prev[j][h][e] = first || col + 8 * h >= Cout ? 0.f : dwd[o];
          }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long o = static_cast<long>(h0 + j * 8 + 2 * (lane % 4) + e) * Cout + col + 8 * h;
            if (col + 8 * h < Cout) dwd[o] = prev[j][h][e] + g[j][2 * h + e];
          }
      if (own_db && tid < CC && ci * CC + tid < Cout)
        combo_part(db_dec_part, part, cb)[static_cast<long>(si) * Cout + ci * CC + tid] = dd;
    }
  }

  // db_enc and the other per-latent sums: per-thread column sums, over the
  // lanes of a column, then over the eight warps' row groups, in a fixed order;
  // the ring is free once every consumer is past its last tile
  __syncthreads();
  constexpr int kSums = kVar ? kNS : 1;
  float* red_s = reinterpret_cast<float*>(ring);  // [kSums][8][TH]
  // kSae: [TH] round_bf16(db_enc); Gated: round_bf16(sum dg)
  float* bcd_s = red_s + kSums * 8 * TH;
  if constexpr (!kVar) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = gbe[j][e];
#pragma unroll
        for (int off = 4; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < 4) red_s[warp * TH + j * 8 + 2 * lane + e] = v;
      }
  } else {
#pragma unroll
    for (int q = 0; q < kNS; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) red_s[(q * 8 + warp) * TH + 2 * lane + e] = vs[q][e];
  }
  __syncthreads();
  float s[kSums];
  if (tid < TH)
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      s[q] = red_s[q * 8 * TH + tid];
      for (int w = 1; w < 8; ++w) s[q] += red_s[(q * 8 + w) * TH + tid];  // fixed order
    }
  if (n_split > 1) {  // the last split of this latent block goes on (header note, "Splits")
    const long enc = static_cast<long>(gridDim.y) * Cin * H, dec = static_cast<long>(gridDim.y) * H * Cout;
    float* const ws_dec = split_ws + (n_split - 1) * enc;
    if (!last_split(s, ws_dec + (n_split - 1) * dec, H, blk, reinterpret_cast<int*>(bcd_s + TH)))
      return;
    add_split_tiles(combo_part(dw_enc, static_cast<long>(Cin) * H, cb) + h0,
                    split_ws + cb * (enc / gridDim.y) + h0, enc, Cin, H, TH);
    add_split_tiles(combo_part(dw_dec, static_cast<long>(H) * Cout, cb) + static_cast<long>(h0) * Cout,
                    ws_dec + cb * (dec / gridDim.y) + static_cast<long>(h0) * Cout, dec, 1, 0,
                    TH * Cout);
  }
  if (tid < TH) {
    combo_part(db_enc, H, cb)[h0 + tid] = s[0];  // Gated: db_gate
    if constexpr (kAct == Act::Relu) {
      if constexpr (kSae) bcd_s[tid] = __bfloat162float(__float2bfloat16(s[0]));
    } else if constexpr (kAct == Act::Jump) {
      combo_part(sae.act.dtheta, H, cb)[h0 + tid] = s[1];
      bcd_s[tid] = __bfloat162float(__float2bfloat16(s[0]));
    } else {
      combo_part(sae.act.db_mag, H, cb)[h0 + tid] = s[1];
      combo_part(sae.act.dr_mag, H, cb)[h0 + tid] = __fmul_rn(s[2], v2_s[tid]);
      bcd_s[tid] = __bfloat162float(__float2bfloat16(s[kNS - 1]));
    }
  }
  if constexpr (kSae) {  // this block's row of db_dec's centring term
    __syncthreads();
    for (int k = tid; k < Cin; k += kThreads) {
      // W_enc[k, h0 : h0 + 64]: 128 bytes, eight 16-byte loads
      const uint4* row = reinterpret_cast<const uint4*>(
          combo_part(static_cast<const bf16*>(sae.w_enc), static_cast<long>(Cin) * H, cb) +
          static_cast<long>(k) * H + h0);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < TH / 8; ++q) {
        const uint4 v = row[q];
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(e[i]);
          s = fmaf(bcd_s[q * 8 + 2 * i], f.x, s);
          s = fmaf(bcd_s[q * 8 + 2 * i + 1], f.y, s);
        }
      }
      combo_part(sae.db_cent, part, cb)[static_cast<long>(blk.x) * Cin + k] = -s;
    }
  }
}

// Backward, bf16, gradient tiles held in registers: the route of
// ops/fused_sae.bwd_route for Act::Relu, one level, Cin <= kHeldCin and
// kHeldMinCout < Cout <= kHeldCout (the transcoder; header note, "Tiling"). Two
// launches over the same latent blocks, each holding one gradient tile [64
// latents][W] f32 for its whole token sweep and writing it once: no in-place
// updates. Blocks, steps, sub-steps, combos and splits are coder_bwd_tc's. The
// block's W tiles (W_enc [Cin][64]; pass E also W_dec [64][Cout]) are loaded
// once and stay in shared memory, so the ring (kHeldSt slots of two [64][64]
// boxes) streams only x and err. Per step of 512 tokens:
//   pass E (kDec false; W = kHeldCin): A. per 128 tokens, pre = x @ W_enc tile
//     and dpost = round_bf16(c_rec*err) @ W_dec tile^T (x and err [128][64] per
//     64 channels, as coder_bwd_tc's phase A), round_bf16(dpre) into buf_s
//     [512][64] and db_enc's sums; then per 64 tokens, per pair of 64-channel
//     boxes p, x [64][128]: dW_enc[p] += x[:, p]^T @ round_bf16(dpre) (A
//     MN-major from shared memory). Holds dW_enc [W][64] (warpgroup g:
//     channels 128p + 64g .., W/128 m64 accumulators); ends with db_enc as
//     coder_bwd_tc's blocks do.
//   pass D (kDec true; W = kHeldCout): A. per 128 tokens, pre only,
//     round_bf16(post) into buf_s; then per 64 tokens, per pair of 64-column
//     boxes p, err [64][128]: dW_dec[:, p]^T += round_bf16(c_rec*err[:, p])^T @
//     round_bf16(post) (A from registers, ldmatrix.trans, scaled and rounded
//     as phase C's). Holds dW_dec^T [W][64] as pass E holds dW_enc (columns
//     past Cout arrive as zeros and are not stored), and sums step si's db_dec
//     row in block si % (H / 64), as phase C does. Pass D recomputes pre:
//     2*T*H*(3*Cin + 2*Cout) FLOP in all where coder_bwd_tc does
//     2*T*H*(2*Cin + 2*Cout).
// The register-A products (pass E's dpost, pass D's held product) alternate
// kHeldSets fragment sets, so one tile's products stay in flight while the next
// tile's fragments load. Every product has accumulators of its own.
// What bounds it (chip_bwd_probe.py on an H100 80GB HBM3 at 700 W; PERF.md,
// "Findings"): the passes with no wgmma issued take 0.60 of the time, ~0.3 us
// a 16 KB tile a block, and the products do not overlap them. Not the
// L2-to-SM bytes: in scratch builds resident W tiles cut them by a quarter and
// the time by little, and pairs of blocks sharing every x / err box by TMA
// multicast ran slower; tiles of four boxes sped the loads and slowed the
// whole. Against coder_bwd_tc (chip_smoke.py's "[route]" lines) the route
// wins where the in-place updates it drops are large (C_out 480: 1.10-1.11x)
// and was no faster at C 256 (bwd_route's boundary).
// Splits: split z writes its held tile once, into its partial (split_dw); the
// split that draws a latent block's last ticket adds the others in split order
// (pass E through last_split, with db_enc; pass D's tickets are the second [N][H
// / 64] ints of split_ws).
template <bool kDec>
__global__ void __launch_bounds__(kThreads, 1)
coder_bwd_held(const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_we,
               const __grid_constant__ CUtensorMap m_wd,
               const __grid_constant__ CUtensorMap m_err, const float* __restrict__ b_enc,
               const float* __restrict__ coeffs, const float* __restrict__ ct,
               float* __restrict__ dw_enc, float* __restrict__ db_enc,
               float* __restrict__ dw_dec, float* __restrict__ db_dec_part, int n_tokens,
               int Cin, int Cout, int H, float* __restrict__ split_ws) {
  constexpr int TH = kTcBwdTH, TU = kTcBwdTU, TS = kTcBwdTS, KT = 64;
  constexpr int W = kDec ? kHeldCout : kHeldCin;  // the held tile's rows
  constexpr int NP = W / 128;  // box pairs per 64 tokens: m64 accumulators a warpgroup
  constexpr int kSets = kDec ? kHeldSets : 1;  // pass D's held product (pass E's: A in shared memory)
  static_assert(kSets == 1 || NP % kSets == 0, "a pair's fragment set is p % kSets");
  constexpr int kEncBoxes = kHeldCin / 64;  // W_enc tile boxes; pass E's W_dec boxes follow
  extern __shared__ __align__(1024) unsigned char tc_smem_held[];
  unsigned char* ring = align1024(tc_smem_held);
  unsigned char* w_s = ring + kHeldSt * kHeldSlot;  // W_enc [Cin][64] (, W_dec [64][Cout]) boxes
  // [TS][64]: pass E round_bf16(dpre), pass D round_bf16(post)
  unsigned char* buf_s = w_s + (kEncBoxes + (kDec ? 0 : kHeldCout / 64)) * kBox;
  float* benc_s = reinterpret_cast<float*>(buf_s + TS * kSwRow);  // [TH] b_enc
  float* ct_s = benc_s + TH;                                      // [TH] ct (pass E)
  uint64_t* full = reinterpret_cast<uint64_t*>(ct_s + TH);
  uint64_t* empty = full + kHeldSt;
  uint64_t* w_full = empty + kHeldSt;  // the W tiles' one load

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const BwdBlock blk = bwd_block();  // latent block, combo, split
  const int h0 = blk.x * TH, cb = blk.combo;
  const int nki = (Cin + KT - 1) / KT, nko = (Cout + KT - 1) / KT;
  const int n_steps = (n_tokens + TS - 1) / TS, split = blk.split, n_split = gridDim.z;
  const int t_lo = split * n_steps / n_split * TS;
  const int t_hi = min(n_tokens, (split + 1) * n_steps / n_split * TS);
  if (tid < TH) {
    benc_s[tid] = combo_part(b_enc, H, cb)[h0 + tid];
    if constexpr (!kDec) ct_s[tid] = combo_part(ct, H, cb)[h0 + tid];
  }
  if (tid == 0) {
    mbar_init(w_full, 1);
    init_ring<kHeldSt>(full, empty);
  }
  __syncthreads();

  // the block's W tiles, loaded once and resident for the whole sweep: W_enc
  // [Cin][64] as nki boxes [64][64] (MN-major B of pre), pass E also W_dec
  // [64][Cout] as nko boxes (K-major B of dpost)
  const CUtensorMap *mx = &m_x, *mwe = &m_we, *mwd = &m_wd, *merr = &m_err;  // param space
  if (tid == 0) {
    mbar_expect_tx(w_full, (nki + (kDec ? 0 : nko)) * kBox);
    for (int k = 0; k < nki; ++k) tma_box(w_s + k * kBox, mwe, w_full, h0, k * KT, cb);
    if constexpr (!kDec)
      for (int k = 0; k < nko; ++k)
        tma_box(w_s + (kEncBoxes + k) * kBox, mwd, w_full, k * KT, h0, cb);
  }

  // the tile stream, issued by thread 0 as coder_bwd_tc's, every tile two
  // boxes: per step, phase A's x tiles [128][64] (pass E: then its err
  // tiles), then per 64 tokens the NP box pairs [64][128]
  Producer<kHeldSt> prod{ring, kHeldSlot, full, empty};
  int p_t = t_lo, p_ph = 0, p_a = 0, p_k = 0;
  auto issue = [&]() {
    if (tid != 0 || p_t >= t_hi) return;
    const int ntok = min(TS, n_tokens - p_t);
    unsigned char* d = prod.acquire(2 * kBox);
    if (p_ph == 0) {
      const int r0 = p_t + p_a * TU;
      if (kDec || p_k < nki) {  // a branch, not a select of the two maps (coder_bwd_tc)
        tma_box(d, mx, prod.bar, p_k * KT, r0, cb);
        tma_box(d + kBox, mx, prod.bar, p_k * KT, r0 + 64, cb);
      } else {
        const int k0 = (p_k - nki) * KT;
        tma_box(d, merr, prod.bar, k0, r0, cb);
        tma_box(d + kBox, merr, prod.bar, k0, r0 + 64, cb);
      }
      if (++p_k == nki + (kDec ? 0 : nko)) {
        p_k = 0;
        if (++p_a == ntok / TU) p_a = 0, p_ph = 1;
      }
    } else {
      const int r = p_t + p_a * KT;
      const CUtensorMap* m = kDec ? merr : mx;  // a constant: one map a pass
      tma_box(d, m, prod.bar, p_k * 128, r, cb);
      tma_box(d + kBox, m, prod.bar, p_k * 128 + 64, r, cb);
      if (++p_k == NP) {
        p_k = 0;
        if (++p_a == ntok / KT) p_a = 0, p_ph = 0, p_t += TS;
      }
    }
  };
  for (int i = 0; i < kHeldSt - 1; ++i) issue();
  const int wg = warp / 4, w4 = warp % 4;  // warpgroup, warp in it
  const float c_rec = combo_part(coeffs, 2, cb)[0];
  Consumer<kHeldSt> c{ring, kHeldSlot, full, empty, lane};
  const uint32_t buf_a = smem_u32(buf_s), w_a = smem_u32(w_s);
  mbar_wait(w_full, 0);

  // the held tile: g[p][j][2h + e] is row 128p + 64wg + 16w4 + lane/4 + 8h (E: a
  // channel of dW_enc; D: a column of dW_dec), latent h0 + 8j + 2*(lane%4) + e
  float g[NP][8][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) g[p][j][i] = 0.f;
  float gbe[8][2];  // pass E: db_enc of columns 8j + 2*(lane%4) + e over this thread's rows
#pragma unroll
  for (int j = 0; j < 8; ++j) gbe[j][0] = gbe[j][1] = 0.f;

  for (int t = t_lo, si = t_lo / TS; t < t_hi; t += TS, ++si) {
    const int ntok = min(TS, n_tokens - t);

    // A. pre = x @ W_enc tile (+ b_enc); pass E also dpost = round_bf16(c_rec*err)
    // @ W_dec tile^T, in accumulators of its own (header note, kDx)
    for (int u = 0; u < ntok / TU; ++u) {
      float pre[8][4];
      for (int k = 0; k < nki; ++k) {
        const uint32_t s = smem_u32(c.next());
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 1>(pre, sw128_desc(s + wg * kBox + kk * 32),
                         sw128_desc(w_a + k * kBox + kk * 16 * kSwRow), k + kk > 0);
        wg_commit();
        c.issued<true>();
        issue();
      }
      [[maybe_unused]] float dp[8][4];
      if constexpr (!kDec) {
        // kHeldSets fragment sets, tile k in set k % kHeldSets (unrolled, so
        // the set is a constant): with two, one tile's products stay in flight
        uint32_t ea[kHeldSets][4][4];
        auto dpost_tile = [&](uint32_t(&a)[4][4], int k) {
          const unsigned char* slot = c.next();
          scaled_frags(a, slot, wg * 64 + w4 * 16, lane, c_rec);
          const uint32_t wd_k = w_a + (kEncBoxes + k) * kBox;  // W_dec tile box k
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<0>(dp, a[kk], sw128_desc(wd_k + kk * 32), k + kk > 0);
          wg_commit();
          c.issued<kHeldSets == 2>();  // one set: a is rewritten by the next tile
          issue();
        };
        for (int k = 0; k < nko; k += kHeldSets)
#pragma unroll
          for (int q = 0; q < kHeldSets; ++q)
            if (k + q < nko) dpost_tile(ea[q], k + q);
      }
      c.drain();
      __syncthreads();  // both warpgroups' held products of the last step are done with buf_s
      const int tok0 = u * TU + wg * 64 + w4 * 16 + lane / 4;  // this thread's first row
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = j * 8 + 2 * (lane % 4);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = pre[j][2 * h + e] + benc_s[l + e];
            if constexpr (kDec) {
              v[e] = fmaxf(p, 0.f);
            } else {
              v[e] = p > 0.f ? dp[j][2 * h + e] + ct_s[l + e] : 0.f;
              gbe[j][e] += v[e];
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(buf_s + sw128(tok0 + 8 * h, j) + (lane % 4) * 4) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
    }
    fence_async_smem();  // buf_s before wgmma reads it
    __syncthreads();

    // the held product over the step's tokens, 64 at a time, every box pair p
    const bool own_db = kDec && si % static_cast<int>(gridDim.x) == blk.x;
    float dd[NP];  // own_db: column 128p + tid of db_dec over the step (tid < 128)
#pragma unroll
    for (int p = 0; p < NP; ++p) dd[p] = 0.f;
    [[maybe_unused]] uint32_t af[kSets][4][4];
    for (int k = 0; k < ntok / KT; ++k) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const unsigned char* slot = c.next();
        const uint32_t rows = buf_a + k * KT * kSwRow;  // B: 64 tokens of buf_s
        if constexpr (kDec) {
          uint32_t(&a)[4][4] = af[p % kSets];
          scaled_frags_t(a, slot + wg * kBox, w4 * 16, lane, c_rec);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<1>(g[p], a[kk], sw128_desc(rows + kk * 16 * kSwRow), true);
          wg_commit();
          if (own_db && tid < 128) {
            const unsigned char* col = slot + (tid / 64) * kBox + (tid % 8) * 2;
            for (int r = 0; r < KT; ++r)
              dd[p] += c_rec * __bfloat162float(
                                   *reinterpret_cast<const bf16*>(col + sw128(r, (tid % 64) / 8)));
          }
          // with two sets the last pair's fragments are free once one product is in flight
          c.issued<kSets == 2>();
        } else {
          const uint32_t s = smem_u32(slot);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<1, 1>(g[p], sw128_desc(s + wg * kBox + kk * 16 * kSwRow),
                           sw128_desc(rows + kk * 16 * kSwRow), true);
          wg_commit();
          c.issued<true>();
        }
        issue();
      }
    }
    if (own_db && tid < 128)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (p * 128 + tid < Cout)
          combo_part(db_dec_part, static_cast<long>(n_steps) * Cout, cb)[
              static_cast<long>(si) * Cout + p * 128 + tid] = dd[p];
  }
  c.drain();

  // the held tile, written once into this split's partial (split 0's is the output)
  const long enc = static_cast<long>(gridDim.y) * Cin * H, dec = static_cast<long>(gridDim.y) * H * Cout;
  float* const ws_dec = split_ws + (n_split - 1) * enc;  // dW_dec partials; then the sums
  float* const out = kDec ? split_dw(dw_dec, ws_dec, static_cast<long>(H) * Cout, blk)
                          : split_dw(dw_enc, split_ws, static_cast<long>(Cin) * H, blk);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p * 128 + wg * 64 + w4 * 16 + lane / 4 + 8 * h;
      if (row < (kDec ? Cout : Cin))
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int l = h0 + j * 8 + 2 * (lane % 4);
          if constexpr (kDec) {
            out[static_cast<long>(l) * Cout + row] = g[p][j][2 * h];
            out[static_cast<long>(l + 1) * Cout + row] = g[p][j][2 * h + 1];
          } else {
            *reinterpret_cast<float2*>(out + static_cast<long>(row) * H + l) =
                make_float2(g[p][j][2 * h], g[p][j][2 * h + 1]);
          }
        }
    }
  __syncthreads();  // every consumer is past its last tile: the ring is scratch
  float* red_s = reinterpret_cast<float*>(ring);  // [8][TH]
  int* flag = reinterpret_cast<int*>(red_s + 8 * TH);
  if constexpr (kDec) {
    if (n_split > 1) {  // the last split of this latent block adds the others' partials
      int* tickets = reinterpret_cast<int*>(ws_dec + (n_split - 1) * dec +
                                            static_cast<long>(n_split) * gridDim.y * kSplitSums * H);
      if (!last_ticket(tickets + (gridDim.y + cb) * gridDim.x + blk.x, flag)) return;
      add_split_tiles(combo_part(dw_dec, static_cast<long>(H) * Cout, cb) + static_cast<long>(h0) * Cout,
                      ws_dec + cb * (dec / gridDim.y) + static_cast<long>(h0) * Cout, dec, 1, 0,
                      TH * Cout);
    }
  } else {
    // db_enc: per-thread column sums, over the lanes of a column, then over the
    // eight warps' row groups, in a fixed order
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = gbe[j][e];
#pragma unroll
        for (int off = 4; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < 4) red_s[warp * TH + j * 8 + 2 * lane + e] = v;
      }
    __syncthreads();
    float s[1];
    if (tid < TH) {
      s[0] = red_s[tid];
      for (int w = 1; w < 8; ++w) s[0] += red_s[w * TH + tid];  // fixed order
    }
    if (n_split > 1) {  // the last split of this latent block goes on (header note, "Splits")
      if (!last_split(s, ws_dec + (n_split - 1) * dec, H, blk, flag)) return;
      add_split_tiles(combo_part(dw_enc, static_cast<long>(Cin) * H, cb) + h0,
                      split_ws + cb * (enc / gridDim.y) + h0, enc, Cin, H, TH);
    }
    if (tid < TH) combo_part(db_enc, H, cb)[h0 + tid] = s[0];
  }
}

// Backward, bf16, cluster pair: the route of ops/fused_sae.bwd_route for a
// one-level JumpReLU backward (Act::Jump: rows 5, 20 and 32), a ReLU or
// Matryoshka SAE backward (Act::Relu, any prefix levels: rows 2, 9, 16, 22,
// 28 and 34) and a gated SAE backward (Act::Gated: rows 7, 18 and 30), each
// with C <= kPairCmax. Two CTAs
// of a thread block cluster own one 64-latent block, so the block has two SMs'
// registers: rank 0, "E", holds dW_enc [C][64] and rank 1, "D", dW_dec^T
// [C][64] for the whole token sweep and writes it once. Each rank keeps its W
// tile resident (E: W_enc [C][64], D: W_dec [64][C]) and streams its token
// tiles once (E: x_cent, D: round_bf16(c_rec * err) from scale_err_kernel, or
// the Matryoshka SAE's S as it is, c_rec being 1), [64 tokens][C] a sub-step. Warpgroup w of each rank takes the sub-steps u = w
// (mod 2) on a ring, messages and mbarriers of its own and holds its own
// gradient tile (four m64 accumulators, 128 f32 registers a thread): the two
// warpgroups run out of step, so one's products overlap the other's epilogue
// and exchange. Per sub-step u of warpgroup w (every product m64n64, 64 deep):
//   E: pre^T = W_enc tile^T @ x_u^T + b_enc [64 latents][64 tokens] (f32), the
//      JumpReLU tests on that f32 pre (mask pre > theta, window |pre - theta|
//      <= eps/2, two words of bits a thread) and round_bf16(post^T), staged and
//      sent to D's warpgroup w by one bulk copy (cp.async.bulk shared::cta ->
//      shared::cluster, complete_tx on D's barrier); then, kPairLag of its
//      sub-steps behind, dW_enc += x_u^T @ round_bf16(dpre_u) once D's dpre^T
//      has arrived.
//   D: dpost^T = W_dec tile @ err_u^T (f32), then on E's message dpre = mask ?
//      dpost : 0 (no L1 cotangent), the per-latent sums of dpre (db_enc) and of
//      win * (dpost * (-theta/eps) + c_l0 * (-1/eps)) (dtheta), round_bf16(
//      dpre^T) sent back to E's warpgroup w; then dW_dec^T += err_u^T @
//      round_bf16(post_u).
// Act::Relu is the same exchange with coder_bwd_tc's ReLU epilogue: E sends
// round_bf16(max(pre, 0)^T) and one mask word, pre > 0 (the window word is 0:
// the message keeps its layout), and D's dpre = mask ? dpost + ct : 0, ct the
// per-latent L1 cotangent in theta's place in shared memory; no dtheta. D's
// err rows are its block's prefix level's (q*T on, as coder_bwd_tc's qrow;
// level boundaries are multiples of 128, so a block never straddles two).
// Act::Gated (10*T*C*H FLOP; m_we maps W_gate, b_enc is b_gate, D's err map
// covers [2 * n_tokens] rows a combo, err_via from row n_tokens on) moves the
// epilogue to D. E runs g^T = W_gate tile^T @ x_u^T and sends it as it is, f32
// (a thread's 32 accumulators, its 16-byte chunk j at chunk j * 128 + thread:
// kPairGMsg bytes into D's one g^T slot), then holds dW_gate += x_u^T @
// round_bf16(dg_u). D streams two token tiles a sub-step (round_bf16(c_rec *
// err_rec) and round_bf16(c_aux * err_via), its ring's two slots) and runs
// three products against its W_dec tile: denc^T;
// on E's g, coder_bwd_tc's gated epilogue with its f32 operations (pre_gate =
// g + b_gate, pre_mag = g*er + b_mag, the gate 1 / 0.5 / 0, d_premag = pre_mag
// > 0 ? denc*gate : 0), round_bf16(enc^T) into a box of its own and d_premag*er
// over g in the slot (one accumulator set a thread); then d_relu_pi^T from
// err_via, d_pregate = pre_gate > 0 ? d_relu_pi + c_l1 : 0, dg = d_premag*er +
// d_pregate, round_bf16(dg^T) sent to E; then dW_dec^T += err_rec_u^T @
// round_bf16(enc_u). Its sums are Sigma d_pregate (db_gate), Sigma d_premag
// (db_mag), Sigma d_premag*g (times er: dr_mag) and Sigma dg (the centring
// row, against W_gate). A named barrier of the warpgroup orders the enc box's
// writes and the dW_dec product's reads. At 255 registers the order is the
// budget's: the dW_dec product first or the two error products' accumulators
// held together spilled, and so did E sending round_bf16(enc^T) with g
// (PERF.md, the gated pair's findings).
// The mask and window come from E's f32 pre: D never re-derives them. Each
// receive slot has a full barrier in the receiver (armed by its warpgroup's
// first thread for the message's bytes) and an empty barrier in the sender
// (the receiving warpgroup's four warps arrive remotely once done with the
// slot); the staging buffer is refilled only after its copy has read it
// (stage_free). No __syncthreads in the sweep: the rings', slots' and staging
// buffers' mbarriers order everything. 8*T*C*H FLOP, nothing recomputed.
// Sub-steps of 64 tokens: E holds a token tile from its encode to its dW_enc
// product, a sub-step of its warpgroup later, and a tile of 128 tokens is 64 KB
// at C 256: two warpgroups' rings of two would not fit beside the W tile.
// Combos and splits are coder_bwd_tc's (pair_block; grid (2 * H / 64, N, s)):
// E's split partials and tickets (the second [N][H / 64] array of split_ws) for
// dW_enc, D's for dW_dec with the per-latent sums (last_split), and the last
// split of each adds the others' tiles in split order. D writes db_enc, dtheta
// (Jump), db_mag and dr_mag (Gated) and db_dec's centring row (W_enc from
// device memory, as coder_bwd_tc). Both
// ranks meet at a cluster barrier after the sweep, before which every remote
// access is done. Sums in a fixed order: each warpgroup's tile sums its
// sub-steps in f32, then warpgroup 0's tile plus warpgroup 1's; the per-latent
// sums add a thread's tokens of each sub-step, then the sweep, then the four
// lanes and two warpgroups of a latent. Repeat launches give the same bits,
// though not coder_bwd_tc's (which adds dW per 512-token step).
__device__ __forceinline__ BwdBlock pair_block() {
  const int s = gridDim.z, gx = gridDim.x / 2;
  const int i = blockIdx.x / 2 + gx * (blockIdx.y + gridDim.y * blockIdx.z);
  return {i / s % gx, i / s / gx, i % s};
}

template <Act kAct>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
coder_bwd_pair(const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_we,
               const __grid_constant__ CUtensorMap m_wd,
               const __grid_constant__ CUtensorMap m_err, const float* __restrict__ b_enc,
               const float* __restrict__ coeffs, const float* __restrict__ ct,
               float* __restrict__ dw_enc, float* __restrict__ db_enc,
               float* __restrict__ dw_dec, int n_tokens, int C, int H, const SaeBwd sae,
               float* __restrict__ split_ws) {
  static_assert(kAct == Act::Jump || kAct == Act::Relu || kAct == Act::Gated,
                "the pair's epilogues are the JumpReLU, ReLU and gated SAEs'");
  constexpr bool kJump = kAct == Act::Jump, kGated = kAct == Act::Gated;
  constexpr int TH = kTcBwdTH, TU = kPairTU, TS = kTcBwdTS, St = kPairSt, L = kPairLag;
  constexpr int R = kPairRecv, NQ = kPairCmax / 64;  // NQ: held m64 tiles, a channel box each
  constexpr int kNS = kGated ? 4 : 2;                 // D's per-latent sums
  static_assert(R == 2 && St == 2, "Gated: E's two dg^T slots, D's ring of err_rec and err_via");
  extern __shared__ __align__(1024) unsigned char tc_smem_pair[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, w4 = warp % 4, wtid = tid % 128;  // warpgroup, warp and thread in it
  const bool first = wtid == 0;  // the warpgroup's producer and sender
  // this warpgroup's ring [St] and messages (receive slots, then the staging
  // buffer; pair_part), then the W tile, the per-latent vectors, the mbarriers
  unsigned char* base = align1024(tc_smem_pair);
  constexpr int kPart = pair_part(kAct);  // a warpgroup's buffers
  unsigned char* ring = base + wg * kPart;
  unsigned char* recv_s = ring + St * kPairSlot;
  unsigned char* stage_s = recv_s + (kGated ? kPairGMsg : R * kPairMsg);
  unsigned char* enc_s = stage_s + kBox;  // Gated D: round_bf16(enc^T) [64 latents][64 tokens]
  unsigned char* w_s = base + 2 * kPart;
  float* benc_s = reinterpret_cast<float*>(w_s + NQ * kBox);  // [TH] b_enc; Gated: b_gate
  float* th_s = benc_s + TH;        // [TH] theta; Relu: ct; Gated: b_mag
  float* v2_s = th_s + TH;          // [TH] Jump: -theta/eps; Gated: exp(r_mag)
  uint64_t* bars0 = reinterpret_cast<uint64_t*>(v2_s + TH);     // [2][kPairBars], then w_full
  uint64_t* full = bars0 + wg * kPairBars;
  uint64_t* empty = full + St;
  uint64_t* recv_full = empty + St;      // [R] a receive slot's message has arrived
  uint64_t* send_empty = recv_full + R;  // [R] the peer's warpgroup is done with its slot
  uint64_t* staged = send_empty + R;     // the warpgroup has written the message out
  uint64_t* stage_free = staged + 1;     // its copy has read the staging buffer
  uint64_t* w_full = bars0 + 2 * kPairBars;

  const uint32_t rank = cluster_rank();
  const bool enc = rank == 0;
  const BwdBlock blk = pair_block();  // latent block, combo, split
  const int h0 = blk.x * TH, cb = blk.combo, gx = gridDim.x / 2;
  const int nk = (C + 63) / 64;
  const int n_steps = (n_tokens + TS - 1) / TS, n_split = gridDim.z;
  const int t_lo = blk.split * n_steps / n_split * TS;
  const int t_hi = min(n_tokens, (blk.split + 1) * n_steps / n_split * TS);
  const int n_sub = (t_hi - t_lo) / TU;       // at least 2: T is a multiple of 128
  const int n_mine = (n_sub - wg + 1) / 2;    // this warpgroup's: u = wg + 2j
  // token tiles a sub-step (Gated D: err_rec, then err_via from row T on)
  const int per_sub = kGated && !enc ? 2 : 1;
  // the receive slots of this rank's messages in and of the peer's (the slots'
  // strides and the bytes each message carries): JumpReLU and ReLU both ways R
  // slots of kPairMsg; Gated E -> D one g^T slot, D -> E R dg^T boxes
  const int r_in = kGated && !enc ? 1 : R, r_out = kGated && enc ? 1 : R;
  const int m_in = kGated ? (enc ? kBox : kPairGMsg) : kPairMsg;
  const int m_out = kGated ? (enc ? kPairGMsg : kBox) : kPairMsg;
  const uint32_t in_bytes = kGated ? m_in : enc ? kBox : kPairMsg;
  const uint32_t out_bytes = kGated ? m_out : enc ? kPairMsg : kBox;
  // Relu: D's err rows of the block's prefix level (sae.lv; one level but for
  // the Matryoshka SAE), as coder_bwd_tc's qrow; E does not see levels
  const int qrow = kAct == Act::Relu && !enc ? svt::level_of(sae.lv, h0) * n_tokens : 0;
  if (tid < TH) {
    benc_s[tid] = combo_part(b_enc, H, cb)[h0 + tid];
    if constexpr (kJump) {
      const float th = combo_part(sae.act.theta, H, cb)[h0 + tid];
      th_s[tid] = th;
      v2_s[tid] = __fdiv_rn(-th, sae.act.eps);
    } else if constexpr (kGated) {
      th_s[tid] = combo_part(sae.act.b_mag, H, cb)[h0 + tid];
      v2_s[tid] = combo_part(sae.act.er, H, cb)[h0 + tid];
    } else {
      th_s[tid] = combo_part(ct, H, cb)[h0 + tid];
    }
  }
  if (first) {
    for (int k = 0; k < R; ++k) {
      mbar_init(&recv_full[k], 1);
      mbar_init(&send_empty[k], 4);
    }
    mbar_init(staged, 128);
    mbar_init(stage_free, 1);
    for (int s = 0; s < St; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    if (wg == 0) mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(r_in, n_mine); ++k) mbar_expect_tx(&recv_full[k], in_bytes);
  }
  cluster_sync();  // both CTAs' barriers are initialised before any remote arrive or copy

  // the W tile, loaded once, and this warpgroup's token tiles (its first
  // thread): its tile j (of sub-step wg + 2 * (j / per_sub), x or err, one
  // [64][64] box a 64 channels) into its slot j % St once its warps have
  // released the tile before
  const CUtensorMap *mx = &m_x, *mwe = &m_we, *mwd = &m_wd, *merr = &m_err;  // param space
  if (tid == 0) {
    mbar_expect_tx(w_full, nk * kBox);
    for (int q = 0; q < nk; ++q) {
      if (enc) tma_box(w_s + q * kBox, mwe, w_full, h0, q * 64, cb);  // W_enc [64 ch][64 lat]
      else tma_box(w_s + q * kBox, mwd, w_full, q * 64, h0, cb);      // W_dec [64 lat][64 ch]
    }
  }
  auto issue = [&](int j) {
    if (!first || j >= per_sub * n_mine) return;
    const int s = j % St;
    mbar_wait(&empty[s], ((j / St) & 1) ^ 1);  // the first round passes
    mbar_expect_tx(&full[s], nk * kBox);
    unsigned char* d = ring + s * kPairSlot;
    const int row = t_lo + (wg + 2 * (j / per_sub)) * TU + (j % per_sub) * n_tokens;
    for (int q = 0; q < nk; ++q) {  // a branch, not a select of the two maps (coder_bwd_tc)
      if (enc) tma_box(d + q * kBox, mx, &full[s], q * 64, row, cb);
      else tma_box(d + q * kBox, merr, &full[s], q * 64, qrow + row, cb);
    }
  };
  for (int j = 0; j < St; ++j) issue(j);
  // the peer's receive slots and full barriers of this warpgroup's messages out,
  // and the peer's empty barriers of the slots this warpgroup receives into
  const uint32_t peer_recv = cluster_addr(recv_s, rank ^ 1);
  const uint32_t peer_full = cluster_addr(recv_full, rank ^ 1);
  const uint32_t peer_empty = cluster_addr(send_empty, rank ^ 1);
  const uint32_t w_a = smem_u32(w_s);
  mbar_wait(w_full, 0);

  // pre^T (E; Gated g^T) or dpost^T (D; Gated denc^T, then d_relu_pi^T less
  // c_l1) of tile j: acc[j][2h + e] is latent 16*w4 + lane/4 + 8h, token 8j +
  // 2*(lane%4) + e of the sub-step
  auto transposed = [&](float (&acc)[8][4], int j) {
    mbar_wait(&full[j % St], (j / St) & 1);
    const uint32_t t = smem_u32(ring + (j % St) * kPairSlot);
    wg_fence();
    for (int q = 0; q < nk; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // B: the tile's box q [64 tokens (N)][64 channels (K)], K-major
        const uint64_t b = sw128_desc(t + q * kBox + kk * 32);
        if (enc)  // A: W_enc box q [64 ch (K)][64 lat (M)], MN-major
          wgmma_ss<1, 0>(acc, sw128_desc(w_a + q * kBox + kk * 16 * kSwRow), b, q + kk > 0);
        else  // A: W_dec box q [64 lat (M)][64 ch (K)], K-major
          wgmma_ss<0, 0>(acc, sw128_desc(w_a + q * kBox + kk * 32), b, q + kk > 0);
      }
    wg_commit();
    wg_wait<0>();
  };
  // the held tile: g[q][j][2h + e] is channel 64*q + 16*w4 + lane/4 + 8h (E: a
  // row of dW_enc; D: a column of dW_dec), latent h0 + 8j + 2*(lane%4) + e;
  // g[q] += (tile j's box q)^T @ msg^T, msg a [64 latents][64 tokens] box
  // (K-major B): the received one, or Gated D's own round_bf16(enc^T)
  float g[NQ][8][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) g[q][j][i] = 0.f;
  auto held = [&](int j, const unsigned char* msg) {
    const uint32_t t = smem_u32(ring + (j % St) * kPairSlot), m = smem_u32(msg);
    wg_fence();
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q < nk)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 0>(g[q], sw128_desc(t + q * kBox + kk * 16 * kSwRow),
                         sw128_desc(m + kk * 32), true);
    wg_commit();
    wg_wait<0>();
  };
  // the message of this warpgroup's sub-step j out: before its threads write
  // the staging buffer, the copy of sub-step j - 1 has read it; after, the
  // first thread sends it into the peer's slot j % r_out once the peer is done
  // with that slot
  auto stage_begin = [&](int j) {
    if (j == 0) return;
    if (first) {
      bulk_wait_read();
      mbar_arrive(stage_free);
    }
    mbar_wait(stage_free, (j - 1) & 1);
  };
  auto stage_end = [&](int j) {
    fence_async_smem();  // this thread's writes before the copy's (async proxy) reads
    mbar_arrive(staged);
    if (first) {
      mbar_wait(staged, j & 1);
      mbar_wait(&send_empty[j % r_out], ((j / r_out) & 1) ^ 1);  // the first round passes
      bulk_to_peer(peer_recv + (j % r_out) * m_out, stage_s, out_bytes,
                   peer_full + (j % r_out) * 8);
    }
  };
  // a received message's slot, once this warpgroup's warps are done with it:
  // the peer's next message there may come
  auto release_msg = [&](int j) {
    if (!enc) fence_async_smem();  // D's generic accesses of the slot before the next copy
    __syncwarp();
    if (lane == 0) mbar_arrive_peer(peer_empty + (j % r_in) * 8);
  };
  // token tile j's ring slot, refilled
  auto release_tile = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % St]);
    issue(j + St);
  };
  const int lat = 16 * w4 + lane / 4;  // this thread's latents lat, lat + 8 in the block
  const uint32_t out_o = (lane % 4) * 4;  // its bf16 pairs' bytes in a 16-byte chunk
  // D: the per-latent sums of latents lat + 8h over this thread's tokens (Jump:
  // dpre, dtheta terms; Relu: dpre; Gated: d_pregate, d_premag, d_premag * g, dg)
  float sv[kNS][2];
#pragma unroll
  for (int q = 0; q < kNS; ++q) sv[q][0] = sv[q][1] = 0.f;

  if (enc) {
    for (int i = 0; i < n_mine + L; ++i) {
      if (i < n_mine) {
        float acc[8][4];
        transposed(acc, i);
        stage_begin(i);
        if constexpr (kGated) {
          // g^T as it is, f32: this thread's 32 floats, its 16-byte chunk j at
          // chunk j * 128 + wtid (a warp's stores contiguous), where D's thread
          // wtid, which holds the same latents and tokens, reads it
          float4* out = reinterpret_cast<float4*>(stage_s) + wtid;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            out[j * 128] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        } else {
          // bit 4j + 2h + e: pre > theta (Relu: pre > 0); Jump: in the window
          uint32_t on = 0, win = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int l = lat + 8 * h;
              float p[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = acc[j][2 * h + e] + benc_s[l];
                if constexpr (kJump) {
                  const float th = th_s[l];
                  on |= static_cast<uint32_t>(v > th) << (4 * j + 2 * h + e);
                  win |= static_cast<uint32_t>(fabsf(v - th) <= sae.act.half_eps)
                         << (4 * j + 2 * h + e);
                  p[e] = v > th ? v : 0.f;
                } else {
                  on |= static_cast<uint32_t>(v > 0.f) << (4 * j + 2 * h + e);
                  p[e] = fmaxf(v, 0.f);
                }
              }
              *reinterpret_cast<__nv_bfloat162*>(stage_s + sw128(l, j) + out_o) =
                  __floats2bfloat162_rn(p[0], p[1]);
            }
          reinterpret_cast<uint2*>(stage_s + kBox)[wtid] = make_uint2(on, win);
        }
        stage_end(i);
      }
      if (i >= L) {  // dW_enc += x^T @ round_bf16(dpre) (Gated: dg) of its sub-step k
        const int k = i - L;
        mbar_wait(&recv_full[k % r_in], (k / r_in) & 1);
        if (first && k + r_in < n_mine) mbar_expect_tx(&recv_full[k % r_in], in_bytes);
        held(k, recv_s + (k % r_in) * m_in);
        release_msg(k);
        release_tile(k);
      }
    }
  } else if constexpr (kGated) {
    const float c_l1 = combo_part(coeffs, 3, cb)[1];
    const int bar_id = 1 + wg;  // the warpgroup's named barrier (0 is __syncthreads')
    float4* msg = reinterpret_cast<float4*>(recv_s) + wtid;  // its g^T: chunk j at j * 128
    for (int i = 0; i < n_mine; ++i) {
      float acc[8][4];
      transposed(acc, 2 * i);  // denc^T = W_dec tile @ round_bf16(c_rec * err_rec)^T
      mbar_wait(&recv_full[0], i & 1);
      if (first && i + 1 < n_mine) mbar_expect_tx(&recv_full[0], in_bytes);
      // every warp of the warpgroup is past its last dW_dec product: enc_s is free
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      // coder_bwd_tc's gated epilogue on E's f32 g: round_bf16(enc^T) into
      // enc_s, the sums of d_premag and d_premag * g, d_premag * er (dg's
      // first term) over g in the slot; bit 4j + 2h + e: pre_gate > 0
      uint32_t pos = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 gv = msg[j * 128];
        const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
        float dme[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = lat + 8 * h;
          float en[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i4 = 2 * h + e;
            const float gg = gs[i4], er = v2_s[l];
            const float pg = gg + benc_s[l];
            const float pm = __fadd_rn(__fmul_rn(gg, er), th_s[l]);  // as the plain version
            const float gate = pg > 0.f ? 1.f : (pg == 0.f ? 0.5f : 0.f);
            const float dm = pm > 0.f ? __fmul_rn(acc[j][i4], gate) : 0.f;
            en[e] = gate * fmaxf(pm, 0.f);
            sv[1][h] += dm;
            sv[2][h] += __fmul_rn(dm, gg);
            dme[i4] = __fmul_rn(dm, er);
            pos |= static_cast<uint32_t>(pg > 0.f) << (4 * j + i4);
          }
          *reinterpret_cast<__nv_bfloat162*>(enc_s + sw128(l, j) + out_o) =
              __floats2bfloat162_rn(en[0], en[1]);
        }
        msg[j * 128] = make_float4(dme[0], dme[1], dme[2], dme[3]);
      }
      transposed(acc, 2 * i + 1);  // round_bf16(c_aux * err_via) @ W_dec tile^T, transposed
      release_tile(2 * i + 1);
      // d_pregate = pre_gate > 0 ? d_relu_pi : 0 with d_relu_pi = that + c_l1,
      // dg = d_premag * er + d_pregate; round_bf16(dg^T) to E
      stage_begin(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 dv = msg[j * 128];
        const float dme[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i4 = 2 * h + e;
            const float dpg = (pos >> (4 * j + i4)) & 1u ? acc[j][i4] + c_l1 : 0.f;
            d[e] = __fadd_rn(dme[i4], dpg);
            sv[0][h] += dpg;
            sv[3][h] += d[e];
          }
          *reinterpret_cast<__nv_bfloat162*>(stage_s + sw128(lat + 8 * h, j) + out_o) =
              __floats2bfloat162_rn(d[0], d[1]);
        }
      }
      stage_end(i);  // its fence also orders this thread's enc_s writes before the product's reads
      release_msg(i);
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");  // enc_s is whole
      held(2 * i, enc_s);  // dW_dec^T += err_rec^T @ round_bf16(enc)
      release_tile(2 * i);
    }
  } else {
    const float c_1 = kJump ? __fmul_rn(combo_part(coeffs, 2, cb)[1], sae.act.neg_inv_eps) : 0.f;
    for (int i = 0; i < n_mine; ++i) {
      float acc[8][4];
      transposed(acc, i);
      const unsigned char* msg = recv_s + (i % R) * kPairMsg;
      mbar_wait(&recv_full[i % R], (i / R) & 1);
      if (first && i + R < n_mine) mbar_expect_tx(&recv_full[i % R], in_bytes);
      const uint2 bits = reinterpret_cast<const uint2*>(msg + kBox)[wtid];
      stage_begin(i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = lat + 8 * h;
        const float ctl = kJump ? 0.f : th_s[l];  // Relu: the L1 cotangent
        float sd = 0.f, sw = 0.f;  // this sub-step's, in a fixed order
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = 4 * j + 2 * h + e;
            const float dpost = acc[j][2 * h + e];
            if constexpr (kJump) {
              d[e] = (bits.x >> b) & 1u ? dpost : 0.f;
              if ((bits.y >> b) & 1u) sw += __fadd_rn(__fmul_rn(dpost, v2_s[l]), c_1);
            } else {
              d[e] = (bits.x >> b) & 1u ? dpost + ctl : 0.f;
            }
            sd += d[e];
          }
          *reinterpret_cast<__nv_bfloat162*>(stage_s + sw128(l, j) + out_o) =
              __floats2bfloat162_rn(d[0], d[1]);
        }
        sv[0][h] += sd;
        sv[1][h] += sw;
      }
      stage_end(i);
      held(i, msg);  // dW_dec^T += err^T @ round_bf16(post)
      release_msg(i);
      release_tile(i);
    }
  }
  if (first) bulk_wait_read();
  cluster_sync();  // every remote arrive and copy of both ranks is done

  // the two warpgroups' tiles added (warpgroup 0's first) through shared memory
  // (the rings are free: every tile was consumed), then written once into this
  // split's partial (split 0's is the output)
  float* tile_s = reinterpret_cast<float*>(base);  // [C][64] f32: warpgroup 1's tile
  if (wg == 1)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(tile_s + (q * 64 + lat + 8 * h) * TH + j * 8 +
                                     2 * (lane % 4)) = make_float2(g[q][j][2 * h], g[q][j][2 * h + 1]);
  __syncthreads();
  const long enc_sz = static_cast<long>(gridDim.y) * C * H, dec_sz = enc_sz;
  float* const ws_dec = split_ws + (n_split - 1) * enc_sz;  // dW_dec partials; then the sums
  float* const out = enc ? split_dw(dw_enc, split_ws, static_cast<long>(C) * H, blk)
                         : split_dw(dw_dec, ws_dec, static_cast<long>(H) * C, blk);
  if (wg == 0)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q * 64 + lat + 8 * h;
        if (row < C)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 o = *reinterpret_cast<const float2*>(tile_s + row * TH + j * 8 +
                                                              2 * (lane % 4));
            const float a = g[q][j][2 * h] + o.x, b = g[q][j][2 * h + 1] + o.y;
            const int l = h0 + j * 8 + 2 * (lane % 4);
            if (enc) {
              *reinterpret_cast<float2*>(out + static_cast<long>(row) * H + l) = make_float2(a, b);
            } else {
              out[static_cast<long>(l) * C + row] = a;
              out[static_cast<long>(l + 1) * C + row] = b;
            }
          }
      }
  __syncthreads();  // the tile is read: the scratch below reuses it
  float* red_s = reinterpret_cast<float*>(base);  // [kNS sums][2 warpgroups][TH]
  float* bcd_s = red_s + 2 * kNS * TH;            // [TH] round_bf16(db_enc); Gated: of sum dg
  int* flag = reinterpret_cast<int*>(bcd_s + TH);
  if (enc) {
    if (n_split > 1) {  // the last split of this latent block adds the others' partials
      int* tickets = reinterpret_cast<int*>(ws_dec + (n_split - 1) * dec_sz +
                                            static_cast<long>(n_split) * gridDim.y * kSplitSums * H);
      if (!last_ticket(tickets + (gridDim.y + cb) * gx + blk.x, flag)) return;
      add_split_tiles(combo_part(dw_enc, static_cast<long>(C) * H, cb) + h0,
                      split_ws + cb * (enc_sz / gridDim.y) + h0, enc_sz, C, H, TH);
    }
    return;
  }
  // D: the sums over the four lanes of a latent, then the two warpgroups
#pragma unroll
  for (int q = 0; q < kNS; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off *= 2) sv[q][h] += __shfl_xor_sync(0xffffffffu, sv[q][h], off);
  if (lane % 4 == 0)
#pragma unroll
    for (int q = 0; q < kNS; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) red_s[(2 * q + wg) * TH + lat + 8 * h] = sv[q][h];
  __syncthreads();
  float s[kNS];
#pragma unroll
  for (int q = 0; q < kNS; ++q)
    s[q] = tid < TH ? red_s[2 * q * TH + tid] + red_s[(2 * q + 1) * TH + tid] : 0.f;
  if (n_split > 1) {  // the last split of this latent block goes on (header note, "Splits")
    if (!last_split(s, ws_dec + (n_split - 1) * dec_sz, H, blk, flag, gx)) return;
    add_split_tiles(combo_part(dw_dec, static_cast<long>(H) * C, cb) + static_cast<long>(h0) * C,
                    ws_dec + cb * (dec_sz / gridDim.y) + static_cast<long>(h0) * C, dec_sz, 1, 0,
                    TH * C);
  }
  if (tid < TH) {
    combo_part(db_enc, H, cb)[h0 + tid] = s[0];  // Gated: db_gate
    if constexpr (kJump) combo_part(sae.act.dtheta, H, cb)[h0 + tid] = s[1];
    if constexpr (kGated) {
      combo_part(sae.act.db_mag, H, cb)[h0 + tid] = s[1];
      combo_part(sae.act.dr_mag, H, cb)[h0 + tid] = __fmul_rn(s[2], v2_s[tid]);
    }
    bcd_s[tid] = __bfloat162float(__float2bfloat16(s[kGated ? 3 : 0]));
  }
  __syncthreads();
  // this block's row of db_dec's centring term, -round_bf16(db_enc) @ W_enc tile^T
  // (Gated: -round_bf16(sum dg) @ W_gate tile^T)
  const long part = static_cast<long>(n_steps) * C + static_cast<long>(H / TH) * C;
  for (int k = tid; k < C; k += kThreads) {
    const uint4* row = reinterpret_cast<const uint4*>(
        combo_part(static_cast<const bf16*>(sae.w_enc), static_cast<long>(C) * H, cb) +
        static_cast<long>(k) * H + h0);
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < TH / 8; ++q) {
      const uint4 w = row[q];
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(e[i]);
        v = fmaf(bcd_s[q * 8 + 2 * i], f.x, v);
        v = fmaf(bcd_s[q * 8 + 2 * i + 1], f.y, v);
      }
    }
    combo_part(sae.db_cent, part, cb)[static_cast<long>(blk.x) * C + k] = -v;
  }
}

bool bad_shape(int n_tokens, int c_in, int c_out, int H) {
  return n_tokens <= 0 || c_in <= 0 || c_out <= 0 || H <= 0 || n_tokens % kBwdTB ||
         H % kFwdLG;
}

// the combo axis (header note, "Combos"): at least one combo, within gridDim.y,
// and combo-offset latent indices (blockIdx.y * H + latent) within an int
bool bad_combos(int n_combo, int H) {
  return n_combo < 1 || n_combo > 65535 || static_cast<long>(n_combo) * H > (1L << 30);
}

// the bf16 bodies read 16-byte-aligned rows of whole 16-byte chunks (TMA's
// rule for global strides): widths multiples of 8, aligned operands
bool bad_tc_operands(int c_in, int c_out, const void* x, const void* w_enc, const void* w_dec,
                     const void* out) {
  auto mis = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  return c_in % 8 || c_out % 8 || mis(x) || mis(w_enc) || mis(w_dec) || mis(out);
}

// ---------------------------------------------------------------------------
// The SAEs' pre-passes: centring (every SAE entry point) and the scaled error
// (the JumpReLU and gated backwards)
// ---------------------------------------------------------------------------

// x_cent = round_T(x - round_T(b_dec)) over x [n / C, C]; with bf16 a thread
// takes 8 elements (16 bytes; C is a multiple of 8), with float one. Combos:
// blockIdx.y centres the shared x by its own b_dec [N, C] into its own x_cent
// [N, n / C, C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
center_kernel(const T* __restrict__ x, const float* __restrict__ b_dec, T* __restrict__ out,
              long n, int C) {
  constexpr int V = std::is_same_v<T, float> ? 1 : 8;
  struct alignas(sizeof(T) * V) Pack {
    T v[V];
  };
  b_dec = combo_part(b_dec, C);
  out = combo_part(out, n);
  const long stride = static_cast<long>(gridDim.x) * kThreads * V;
  for (long i = (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) * V; i < n; i += stride) {
    const int c = static_cast<int>(i % C);
    const Pack a = *reinterpret_cast<const Pack*>(x + i);
    Pack r;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = to_f(a.v[e]) - round_cd<T>(b_dec[c + e]);
      if constexpr (std::is_same_v<T, float>) r.v[e] = d;
      else r.v[e] = __float2bfloat16(d);
    }
    *reinterpret_cast<Pack*>(out + i) = r;
  }
}

// x [n_tokens, C] shared by the n_combo combos, b_dec [n_combo, C], x_cent
// [n_combo, n_tokens, C]
cudaError_t launch_center(int bf16, const void* x, const float* b_dec, void* x_cent,
                          int n_tokens, int C, cudaStream_t stream, int n_combo = 1) {
  const long n = static_cast<long>(n_tokens) * C;
  const int per_block = kThreads * (bf16 ? 8 : 1);
  const dim3 grid(static_cast<int>(std::min<long>((n + per_block - 1) / per_block, 132 * 16)),
                  n_combo);
  if (bf16)
    return svt::launch(center_kernel<__nv_bfloat16>, grid, 0, stream,
                       static_cast<const __nv_bfloat16*>(x), b_dec,
                       static_cast<__nv_bfloat16*>(x_cent), n, C);
  return svt::launch(center_kernel<float>, grid, 0, stream, static_cast<const float*>(x),
                     b_dec, static_cast<float*>(x_cent), n, C);
}

// The JumpReLU and gated ops save their errors in f32 and round c * err once,
// just before the products; coder_bwd_tc reads a bf16 err, so this pre-pass
// writes drecon = round_bf16(c * err) [T, C] (c the device coefficient *coef)
// and, where part is not null, the f32 column sums of the unrounded c * err
// over each kTcBwdTS-token step, part [ceil(T / kTcBwdTS), C] in step order:
// the direct rows of db_dec. The ReLU and Matryoshka SAEs' cluster-pair route
// runs it on their bf16 errors (In = bf16; the ReLU SAE's err, whose rounding
// of c_rec * err is coder_bwd_tc's scale_pair bit for bit), and where out is
// null (the Matryoshka SAE's S_0, c_rec 1: no copy) it writes part only. A
// block takes 64 columns of one step; thread (cx, ry) sums rows ry, ry + 4, ..,
// then the four row groups are added in order. Combos: blockIdx.z, a combo's
// err, out, part and coef ``in_stride``, ``out_stride``, ``part_stride`` and
// ``coef_stride`` elements apart. Bound by bytes: 6 bytes a token and channel
// from f32 (32 MB + 16 MB at T = 32,768, C = 256: ~0.015 ms at 3.35 TB/s), 4
// from bf16, 2 without out.
template <typename In>
__global__ void __launch_bounds__(kThreads)
scale_err_kernel(const In* __restrict__ err, const float* __restrict__ coef,
                 bf16* __restrict__ out, float* __restrict__ part, int n_tokens, int C,
                 long in_stride, long out_stride, long part_stride, int coef_stride) {
  __shared__ float red[kThreads];
  const long cz = blockIdx.z;
  err += cz * in_stride;
  if (out) out += cz * out_stride;
  const int cx = threadIdx.x % 64, ry = threadIdx.x / 64, col = blockIdx.x * 64 + cx;
  const int t1 = min(n_tokens, static_cast<int>(blockIdx.y + 1) * kTcBwdTS);
  const float c = coef[cz * coef_stride];
  float s = 0.f;
  if (col < C) {
#pragma unroll 4
    for (int t = blockIdx.y * kTcBwdTS + ry; t < t1; t += 4) {
      const long o = static_cast<long>(t) * C + col;
      const float d = __fmul_rn(c, to_f(err[o]));
      if (out) out[o] = __float2bfloat16(d);
      s += d;
    }
  }
  if (part == nullptr) return;  // the same for every thread of the block
  red[threadIdx.x] = s;
  __syncthreads();
  if (ry == 0 && col < C)
    part[cz * part_stride + static_cast<long>(blockIdx.y) * C + col] =
        ((red[cx] + red[64 + cx]) + red[128 + cx]) + red[192 + cx];
}

// in_stride 0: a combo's err is [n_tokens, C]
template <typename In>
cudaError_t launch_scale_err(const In* err, const float* coef, void* out, float* part,
                             int n_tokens, int C, cudaStream_t stream, int n_combo = 1,
                             long out_stride = 0, long part_stride = 0, int coef_stride = 0,
                             long in_stride = 0) {
  const dim3 grid((C + 63) / 64, (n_tokens + kTcBwdTS - 1) / kTcBwdTS, n_combo);
  scale_err_kernel<In><<<grid, kThreads, 0, stream>>>(
      err, coef, static_cast<bf16*>(out), part, n_tokens, C,
      in_stride ? in_stride : static_cast<long>(n_tokens) * C, out_stride, part_stride,
      coef_stride);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver function: reached through the runtime's
// entry-point query, so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// Tensor map of ``n`` stacked row-major bf16 matrices [n][rows][cols] at base
// (rank 3, the combo outermost; header note, "Combos"), read in boxes of
// [box_rows][64] of one matrix into the 128-byte-swizzled layout; reads past a
// matrix's edge fill zeros. Built per call: the pointers change.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                     int n = 1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * sizeof(bf16),
                                 static_cast<cuuint64_t>(rows) * cols * sizeof(bf16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bf16 forward on x [n_tokens, c_in] (bf16 operands), the body chosen by
// the width: coder_fwd_tc_hold<256> for c_out <= 256, <512> for c_out <= 512,
// else coder_fwd_tc. kAct Gated (recon and via held together) takes c_out <=
// 256 only; GatedEnc and GatedPi, the two launches of the gated forward's wide
// route, c_out > 256 only. act_part and zsum_part are [n_tokens / 64, H]
// (per-64-token partials; GatedEnc writes no zsum_part, GatedPi neither act_part
// nor row_active), row_active [n_tokens], recon [n_tokens, c_out] f32 (kPrefix:
// prefix_recon [lv.n, n_tokens, c_out]; Gated: af.via too). n_combo stacked
// dictionaries run in one launch, every operand and output [n_combo, ...]
// (header note, "Combos"). n_split > 1 (coder_fwd_tc only, at most one split a
// 512-latent group; header note, "Splits") makes recon and row_active partials
// [n_split, n_combo, ...].
template <bool kPrefix, Act kAct>
cudaError_t fwd_tc(const void* x, const void* w_enc, const float* b_enc, const void* w_dec,
                   const float* b_dec, float* recon, float* act_part, float* row_active,
                   float* zsum_part, int n_tokens, int c_in, int c_out, int H,
                   const svt::Levels& lv, const ActFwd& af, cudaStream_t stream,
                   int n_combo = 1, int n_split = 1) {
  constexpr bool kTwo = kAct == Act::GatedEnc || kAct == Act::GatedPi;  // the two-launch route
  if (bad_shape(n_tokens, c_in, c_out, H) || bad_combos(n_combo, H) ||
      bad_tc_operands(c_in, c_out, x, w_enc, w_dec, recon))
    return cudaErrorInvalidValue;
  const int hold = c_out <= 256 ? 256 : c_out <= kHoldCout ? kHoldCout : 0;  // held width
  if ((kAct == Act::Gated && hold != 256) || (kTwo && hold == 256) || n_split < 1 ||
      (n_split > 1 && (hold || n_split > (H + kTcFwdLG - 1) / kTcFwdLG)))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mwe, mwd;
  cudaError_t e;
  if ((e = bf16_map(&mx, x, n_tokens, c_in, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwe, w_enc, c_in, H, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwd, w_dec, H, c_out, hold ? hold_ld(hold) : 64, n_combo)) != cudaSuccess)
    return e;
  if constexpr (kAct == Act::Gated) {
    return svt::launch(coder_fwd_tc_hold<256, kPrefix, kAct>, dim3(n_tokens / kHoldTT, n_combo),
                       hold_smem_bytes(2), stream, mx, mwe, mwd, b_enc, b_dec, recon, act_part,
                       row_active, zsum_part, c_in, c_out, H, lv, af, DxFwd<false>{});
  } else {
    if constexpr (!kTwo)
      if (hold == 256)
        return svt::launch(coder_fwd_tc_hold<256, kPrefix, kAct>,
                           dim3(n_tokens / kHoldTT, n_combo), hold_smem_bytes(), stream, mx, mwe,
                           mwd, b_enc, b_dec, recon, act_part, row_active, zsum_part, c_in,
                           c_out, H, lv, af, DxFwd<false>{});
    if (hold)
      return svt::launch(coder_fwd_tc_hold<kHoldCout, kPrefix, kAct>,
                         dim3(n_tokens / kHoldTT, n_combo), hold_smem_bytes(), stream, mx, mwe,
                         mwd, b_enc, b_dec, recon, act_part, row_active, zsum_part, c_in, c_out,
                         H, lv, af, DxFwd<false>{});
    TcFwd t{};
    t.act = af;
    return svt::launch(coder_fwd_tc<kPrefix, kAct>, dim3(n_tokens / kTcFwdTT, n_combo, n_split),
                       fwd_tc_smem_bytes(), stream, mx, mwe, mwd, b_enc, b_dec, recon, act_part,
                       row_active, zsum_part, c_in, c_out, H, lv, t);
  }
}

// The f32 forward on x [n_tokens, c_in] (float operands, any width): the SIMT
// body coder_fwd_kernel<float, kPrefix, false, kAct>. Outputs as fwd_tc's; the
// gated forward is two launches here at every width, GatedEnc then GatedPi.
template <bool kPrefix, Act kAct>
cudaError_t fwd_simt(const void* x, const void* w_enc, const float* b_enc, const void* w_dec,
                     const float* b_dec, float* recon, float* act_part, float* row_active,
                     float* zsum_part, int n_tokens, int c_in, int c_out, int H,
                     const svt::Levels& lv, const ActFwd& af, cudaStream_t stream,
                     int n_combo = 1) {
  if (bad_shape(n_tokens, c_in, c_out, H) || bad_combos(n_combo, H)) return cudaErrorInvalidValue;
  return svt::launch(coder_fwd_kernel<float, kPrefix, false, kAct>,
                     dim3(n_tokens / kFwdTT, n_combo), fwd_smem_bytes(), stream,
                     static_cast<const float*>(x), static_cast<const float*>(w_enc), b_enc,
                     static_cast<const float*>(w_dec), b_dec, recon, act_part, row_active,
                     zsum_part, c_in, c_out, H, lv, DxFwd<false>{}, af);
}

// Launch the forward: bf16 != 0 selects __nv_bfloat16 operands (fwd_tc's
// route), else float (fwd_simt, never split). Outputs as fwd_tc's.
template <bool kPrefix>
cudaError_t coder_fwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                      const void* w_dec, const float* b_dec, float* recon, float* act_part,
                      float* row_active, float* zsum_part, int n_tokens, int c_in, int c_out,
                      int H, const svt::Levels& lv, cudaStream_t stream, int n_combo = 1,
                      int n_split = 1) {
  if (bad_shape(n_tokens, c_in, c_out, H) || (!bf16 && n_split != 1))
    return cudaErrorInvalidValue;
  if (bf16)
    return fwd_tc<kPrefix, Act::Relu>(x, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                                      row_active, zsum_part, n_tokens, c_in, c_out, H, lv,
                                      ActFwd{}, stream, n_combo, n_split);
  return fwd_simt<kPrefix, Act::Relu>(x, w_enc, b_enc, w_dec, b_dec, recon, act_part,
                                      row_active, zsum_part, n_tokens, c_in, c_out, H, lv,
                                      ActFwd{}, stream, n_combo);
}

// Launch the backward. err is [sae.lv.n * n_tokens, c_out] in the operand type
// (one level but for the Matryoshka SAE); coeffs is a device array whose first
// float is c_rec, ct the [H] per-latent L1 cotangent. Outputs f32: dw_enc
// [c_in, H], db_enc [H], dw_dec [H, c_out], db_dec_part: float operands [2,
// c_out] (two partial sums over alternate token rows), bf16 [ceil(n_tokens /
// 512), c_out] (one per 512-token step); db_dec is the sum of its rows (and,
// with kSae, of sae.db_cent's). n_combo stacked dictionaries in one launch, as
// the forward's.
// The bf16 backward body coder_bwd_tc<kSae, kAct> on x [n_tokens, c_in] and
// err [err_rows, c_out] (bf16 operands). n_split > 1 (at most one split a
// 512-token step; header note, "Splits") needs split_ws: dW_enc [n_split - 1,
// n_combo, c_in, H] and dW_dec [n_split - 1, n_combo, H, c_out] partials and
// the per-latent sums [n_split, n_combo, kSplitSums, H] f32, then [n_combo, H /
// 64] int tickets, zeroed; the outputs keep their shapes.
template <bool kSae, Act kAct>
cudaError_t bwd_tc(const void* x, const void* w_enc, const float* b_enc, const void* w_dec,
                   const void* err, int err_rows, const float* coeffs, const float* ct,
                   float* dw_enc, float* db_enc, float* dw_dec, float* db_dec_part,
                   int n_tokens, int c_in, int c_out, int H, const SaeBwd& sae,
                   cudaStream_t stream, int n_combo = 1, int n_split = 1,
                   void* split_ws = nullptr) {
  if (bad_shape(n_tokens, c_in, c_out, H) || bad_combos(n_combo, H) ||
      bad_tc_operands(c_in, c_out, x, w_enc, w_dec, err) || n_split < 1 ||
      n_split > (n_tokens + kTcBwdTS - 1) / kTcBwdTS || (n_split > 1 && split_ws == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mwe, mwd, merr;
  cudaError_t e;
  if ((e = bf16_map(&mx, x, n_tokens, c_in, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwe, w_enc, c_in, H, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwd, w_dec, H, c_out, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&merr, err, err_rows, c_out, 64, n_combo)) != cudaSuccess)
    return e;
  return svt::launch(coder_bwd_tc<kSae, kAct>, dim3(H / kTcBwdTH, n_combo, n_split),
                     bwd_tc_smem_bytes(kAct == Act::Relu ? 2 : 3), stream, mx, mwe, mwd, merr,
                     b_enc, coeffs, ct, dw_enc, db_enc, dw_dec, db_dec_part, n_tokens, c_in,
                     c_out, H, sae, static_cast<float*>(split_ws));
}

// The held route (coder_bwd_held; the coders' entry point, kSae false):
// ``passes`` bit 0 launches pass E (dW_enc, db_enc), bit 1 then pass D (dW_dec
// and the direct db_dec rows), on the current stream; 3, both, is the
// backward, the others time a pass alone. Operands, outputs, n_combo and
// n_split as bwd_tc's; split_ws as bwd_tc's with two [n_combo, H / 64] ticket
// arrays, pass E's then pass D's, zeroed. Refuses (cudaErrorInvalidValue) the
// widths the route does not take (c_in > kHeldCin, c_out outside (kHeldMinCout,
// kHeldCout]). A template only so that the SAEs' sources, which never launch
// it, do not build its bodies.
template <bool kSae>
cudaError_t bwd_held(int passes, const void* x, const void* w_enc, const float* b_enc,
                     const void* w_dec, const void* err, const float* coeffs, const float* ct,
                     float* dw_enc, float* db_enc, float* dw_dec, float* db_dec_part,
                     int n_tokens, int c_in, int c_out, int H, cudaStream_t stream, int n_combo,
                     int n_split, void* split_ws) {
  if (bad_shape(n_tokens, c_in, c_out, H) || bad_combos(n_combo, H) ||
      bad_tc_operands(c_in, c_out, x, w_enc, w_dec, err) || c_in > kHeldCin ||
      c_out <= kHeldMinCout || c_out > kHeldCout || passes < 1 || passes > 3 || n_split < 1 ||
      n_split > (n_tokens + kTcBwdTS - 1) / kTcBwdTS || (n_split > 1 && split_ws == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mwe, mwd, merr;
  cudaError_t e;
  static_assert(!kSae, "the held route is the coders'");
  if ((e = bf16_map(&mx, x, n_tokens, c_in, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwe, w_enc, c_in, H, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwd, w_dec, H, c_out, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&merr, err, n_tokens, c_out, 64, n_combo)) != cudaSuccess)
    return e;
  const dim3 grid(H / kTcBwdTH, n_combo, n_split);
  float* ws = static_cast<float*>(split_ws);
  if (passes & 1) {
    e = svt::launch(coder_bwd_held<false>, grid, held_smem_bytes(false), stream, mx, mwe, mwd,
                    merr, b_enc, coeffs, ct, dw_enc, db_enc, dw_dec, db_dec_part, n_tokens, c_in,
                    c_out, H, ws);
    if (e != cudaSuccess) return e;
  }
  if (passes & 2)
    return svt::launch(coder_bwd_held<true>, grid, held_smem_bytes(true), stream, mx, mwe, mwd,
                       merr, b_enc, coeffs, ct, dw_enc, db_enc, dw_dec, db_dec_part, n_tokens,
                       c_in, c_out, H, ws);
  return cudaSuccess;
}

// The cluster-pair route (coder_bwd_pair<kAct>; the SAEs' entry points,
// C_in = C_out = C <= kPairCmax): x [n_tokens, C] (x_cent), err [err_rows, C]
// already scaled and rounded (scale_err_kernel; the Matryoshka SAE's S [P *
// n_tokens, C] as it is, sae.lv its levels), outputs and n_combo as bwd_tc's
// with Cin = Cout = C; no direct db_dec rows (the pre-pass writes them); ct the
// per-latent L1 cotangent [n_combo, H] of Act::Relu (null for Act::Jump, which
// has none). n_split as bwd_tc's, split_ws as bwd_tc's with a second [n_combo,
// H / 64] ticket array (E's after D's), zeroed. Grid (2 * H / 64, n_combo,
// n_split) in clusters of two.
template <Act kAct>
cudaError_t bwd_pair(const void* x, const void* w_enc, const float* b_enc, const void* w_dec,
                     const void* err, int err_rows, const float* coeffs, const float* ct,
                     float* dw_enc, float* db_enc, float* dw_dec, int n_tokens, int C, int H,
                     const SaeBwd& sae, cudaStream_t stream, int n_combo, int n_split,
                     void* split_ws) {
  if (bad_shape(n_tokens, C, C, H) || bad_combos(n_combo, H) ||
      bad_tc_operands(C, C, x, w_enc, w_dec, err) || C > kPairCmax || n_split < 1 ||
      n_split > (n_tokens + kTcBwdTS - 1) / kTcBwdTS || (n_split > 1 && split_ws == nullptr) ||
      err_rows < sae.lv.n * n_tokens)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mwe, mwd, merr;
  cudaError_t e;
  if ((e = bf16_map(&mx, x, n_tokens, C, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwe, w_enc, C, H, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&mwd, w_dec, H, C, 64, n_combo)) != cudaSuccess ||
      (e = bf16_map(&merr, err, err_rows, C, 64, n_combo)) != cudaSuccess)
    return e;
  return svt::launch(coder_bwd_pair<kAct>, dim3(2 * H / kTcBwdTH, n_combo, n_split),
                     pair_smem_bytes(kAct), stream, mx, mwe, mwd, merr, b_enc, coeffs, ct, dw_enc,
                     db_enc, dw_dec, n_tokens, C, H, sae, static_cast<float*>(split_ws));
}

// The clusters of coder_bwd_pair<kAct> the card can hold at once
// (cudaOccupancyMaxActiveClusters at its shared memory), or -1 on an error
template <Act kAct>
int pair_clusters() {
  if (cudaFuncSetAttribute(coder_bwd_pair<kAct>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(pair_smem_bytes(kAct))) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * 1024, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = pair_smem_bytes(kAct);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, coder_bwd_pair<kAct>, &cfg) == cudaSuccess ? n : -1;
}

// The f32 backward (float operands, any width): the SIMT body
// coder_bwd_kernel<float, kSae, kAct> on err as saved (kAct Gated: [2 *
// n_tokens, c_out], err_rec then err_via). Outputs as coder_bwd's, float
// operands.
template <bool kSae, Act kAct>
cudaError_t bwd_simt(const void* x, const void* w_enc, const float* b_enc, const void* w_dec,
                     const void* err, const float* coeffs, const float* ct, float* dw_enc,
                     float* db_enc, float* dw_dec, float* db_dec_part, int n_tokens, int c_in,
                     int c_out, int H, const SaeBwd& sae, cudaStream_t stream,
                     int n_combo = 1) {
  if (bad_shape(n_tokens, c_in, c_out, H) || bad_combos(n_combo, H)) return cudaErrorInvalidValue;
  return svt::launch(coder_bwd_kernel<float, kSae, kAct>, dim3(H / kBwdTH, n_combo),
                     bwd_smem_bytes(), stream, static_cast<const float*>(x),
                     static_cast<const float*>(w_enc), b_enc, static_cast<const float*>(w_dec),
                     static_cast<const float*>(err), coeffs, ct, dw_enc, db_enc, dw_dec,
                     db_dec_part, n_tokens, c_in, c_out, H, sae);
}

// bf16: bwd_held's passes when ``held`` (non-zero: bwd_held's ``passes``; the
// caller's route, ops/fused_sae.bwd_route, decides; never kSae), else bwd_tc
// (n_split, split_ws as theirs); float: bwd_simt, never split or held.
template <bool kSae>
cudaError_t coder_bwd(int bf16, const void* x, const void* w_enc, const float* b_enc,
                      const void* w_dec, const void* err, const float* coeffs, const float* ct,
                      float* dw_enc, float* db_enc, float* dw_dec, float* db_dec_part,
                      int n_tokens, int c_in, int c_out, int H, const SaeBwd& sae,
                      cudaStream_t stream, int n_combo = 1, int n_split = 1,
                      void* split_ws = nullptr, int held = 0) {
  if (bad_shape(n_tokens, c_in, c_out, H) || (!bf16 && (n_split != 1 || held)))
    return cudaErrorInvalidValue;
  if (held) {
    if constexpr (kSae) return cudaErrorInvalidValue;  // the SAEs' widths never qualify
    else
      return bwd_held<kSae>(held, x, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc, dw_dec,
                      db_dec_part, n_tokens, c_in, c_out, H, stream, n_combo, n_split, split_ws);
  }
  if (bf16)
    return bwd_tc<kSae, Act::Relu>(x, w_enc, b_enc, w_dec, err, sae.lv.n * n_tokens, coeffs, ct,
                                   dw_enc, db_enc, dw_dec, db_dec_part, n_tokens, c_in, c_out, H,
                                   sae, stream, n_combo, n_split, split_ws);
  return bwd_simt<kSae, Act::Relu>(x, w_enc, b_enc, w_dec, err, coeffs, ct, dw_enc, db_enc,
                                   dw_dec, db_dec_part, n_tokens, c_in, c_out, H, sae, stream,
                                   n_combo);
}

}  // namespace
