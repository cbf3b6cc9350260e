// Shared helpers of the fused FNO-layer kernels (fno_k1.cu, fno_tstage.cu,
// fno_k2.cu). Every kernel reads its activations as T (float or bf16),
// computes in f32 and writes T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fno {

// Activation folded at a layer's input (ops/kernels.py: ACT_CODES).
enum Act : int { kActNone = 0, kActExact = 1, kActTanh = 2 };
// Element type codes (ops/kernels.py: _DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// z = act(a*x + b): the previous layer's folded BatchNorm and its GELU.
__device__ __forceinline__ float affine_act(float x, float a, float b,
                                            int act) {
  const float u = fmaf(a, x, b);
  if (act == kActExact) return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
  if (act == kActTanh) {
    const float inner = 0.79788456080286536f * (u + 0.044715f * u * u * u);
    return 0.5f * u * (1.0f + tanhf(inner));
  }
  return u;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fno
