// Helpers shared by the fused kernels (fused_sae.cu, fused_gated_sae.cu,
// fused_jumprelu_sae.cu, fused_transcoder.cu): the operand-type conversions, the
// rounding to the compute dtype, and the launch and type/width dispatch of the C
// entry points.
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

// Launch ``kernel`` on ``blocks`` x kThreads with ``smem`` bytes of dynamic shared
// memory; returns the cudaError_t of the attribute call or of the launch.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int blocks, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Call f(T{}, std::integral_constant<int, C>{}) for the operand type (bf16 != 0
// selects __nv_bfloat16, else float) and the channel width C in {64, 128, 256}.
template <typename F>
cudaError_t dispatch(int bf16, int C, F&& f) {
  auto by_width = [&](auto t) -> cudaError_t {
    switch (C) {
      case 64: return f(t, std::integral_constant<int, 64>{});
      case 128: return f(t, std::integral_constant<int, 128>{});
      case 256: return f(t, std::integral_constant<int, 256>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return bf16 ? by_width(__nv_bfloat16{}) : by_width(float{});
}

}  // namespace svt
