// Helpers shared by the fused kernels (fused_sae.cu, fused_gated_sae.cu,
// fused_jumprelu_sae.cu, fused_transcoder.cu, coder.cuh): the operand-type
// conversions, the rounding to the compute dtype, the launch helper of the C
// entry points, and the Matryoshka prefix levels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace svt {

constexpr int kThreads = 256;  // every kernel: 16 x 16 threads, tx picks columns, ty rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// round a float to the compute dtype T (round to nearest even), kept as float
template <typename T>
__device__ __forceinline__ float round_cd(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16(v));
  }
}

// Launch ``kernel`` on ``grid`` blocks of kThreads with ``smem`` bytes of dynamic
// shared memory; returns the cudaError_t of the attribute call or of the launch.
// The coder bodies take grid (blocks of one dictionary, combos): the combo axis
// is blockIdx.y (coder.cuh, "Combos").
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

constexpr int kMaxLevels = 16;

// Matryoshka prefix levels, passed by value: level p covers latents [end[p-1],
// end[p]), end[n-1] = H. The ReLU SAE's entry points pass one level. Every lookup
// runs over a fixed-size unrolled loop, so the array is indexed by constants only.
struct Levels {
  int n;
  int end[kMaxLevels];
};

// level of the latent (tile) that starts at h0
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

// the end of the level that holds latent h0
__device__ __forceinline__ int level_end(const Levels lv, int h0) {
  int e = 0;
#pragma unroll
  for (int p = kMaxLevels - 1; p >= 0; --p)
    if (p < lv.n && lv.end[p] > h0) e = lv.end[p];
  return e;
}

// Levels of the prefix boundaries ``bounds`` (host array of n latent counts);
// false unless 1 <= n <= kMaxLevels and the counts are strictly increasing
// multiples of ``quantum`` ending at H.
inline bool make_levels(const int* bounds, int n, int H, int quantum, Levels* lv) {
  if (n < 1 || n > kMaxLevels || bounds[n - 1] != H) return false;
  *lv = Levels{};
  lv->n = n;
  for (int p = 0; p < n; ++p) {
    if (bounds[p] <= (p ? bounds[p - 1] : 0) || bounds[p] % quantum) return false;
    lv->end[p] = bounds[p];
  }
  return true;
}

inline Levels one_level(int H) {
  Levels lv{};
  lv.n = 1;
  lv.end[0] = H;
  return lv;
}

}  // namespace svt
