// Shared helpers of the kernels (fno_k1.cu, fno_tstage.cu, fno_k2.cu,
// fno_k2a.cu, fno_k12b.cu, fno_tail.cu, fno_dft_mma.cuh, temporal_attention.cu,
// galerkin_scores.cu). Every kernel reads its activations as T (float or
// bf16) and computes in f32.
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

// erf by Abramowitz & Stegun 7.1.26, one branch-free path of a reciprocal, an
// exp2 and five FMAs, |error| <= 3e-7 in f32: a third of erff's instructions,
// which set the pace of the tensor-core variants (fno_k2.cu, fno_k1.cu,
// fno_k12b.cu) once their products ran on the tensor cores.
// erf_and_gauss also returns exp(-x^2), which the formula computes anyway.
__device__ __forceinline__ float erf_and_gauss(float x, float& gauss) {
  const float t = fabsf(x);
  const float r = __fdividef(1.f, fmaf(0.3275911f, t, 1.f));
  float p = fmaf(1.061405429f, r, -1.453152027f);
  p = fmaf(p, r, 1.421413741f);
  p = fmaf(p, r, -0.284496736f);
  p = fmaf(p, r, 0.254829592f);
  gauss = exp2f(-1.4426950408889634f * t * t);
  return copysignf(fmaf(-p * r, gauss, 1.f), x);
}
__device__ __forceinline__ float erf_fast(float x) {
  float gauss;
  return erf_and_gauss(x, gauss);
}

// z = act(a*x + b) as fno::affine_act, the exact GELU through erf_fast (its
// error is 1e-4 of a bf16 step of z).
__device__ __forceinline__ float affine_act_fast(float x, float a, float b, int act) {
  if (act != kActExact) return affine_act(x, a, b, act);
  const float u = fmaf(a, x, b);
  return 0.5f * u * (1.f + erf_fast(u * 0.70710678118654752f));
}

// GELU (or identity) of u; act is a kAct* code.
__device__ __forceinline__ float act_fn(float u, int act) { return affine_act(u, 1.f, 0.f, act); }

// d act(u) / du, analytically (realpdebench_tpu/ops/pallas/fno_layer.py::_act_grad).
__device__ __forceinline__ float act_grad(float u, int act) {
  if (act == kActExact) {
    const float phi = 0.39894228040143268f * expf(-0.5f * u * u);
    return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) + u * phi;
  }
  if (act == kActTanh) {
    const float t = tanhf(0.79788456080286536f * (u + 0.044715f * u * u * u));
    const float dinner = 0.79788456080286536f * (1.0f + 3.0f * 0.044715f * u * u);
    return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * dinner;
  }
  return 1.0f;
}

// act_grad with the exact GELU's erf through erf_fast.
__device__ __forceinline__ float act_grad_fast(float u, int act) {
  if (act != kActExact) return act_grad(u, act);
  const float phi = 0.39894228040143268f * exp2f(-0.72134752044448170f * u * u);
  return 0.5f * (1.f + erf_fast(u * 0.70710678118654752f)) + u * phi;
}

// act(u) and act'(u) together; for the exact GELU one erf_and_gauss serves
// both (its exp(-u^2/2) is the density in act'), as in act_grad_fast.
__device__ __forceinline__ void act_and_grad_fast(float u, int act, float& h, float& dh) {
  if (act != kActExact) {
    h = act_fn(u, act);
    dh = act_grad(u, act);
    return;
  }
  float gauss;
  const float e1 = 1.f + erf_and_gauss(u * 0.70710678118654752f, gauss);
  h = 0.5f * u * e1;
  dh = fmaf(u * 0.39894228040143268f, gauss, 0.5f * e1);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Second pass of every cross-block reduction: out[i] = scale * (sum over p
// of partial[p * n + i]) in f64, in a fixed order: thread (r, i) adds the
// partials p = r, r + 32, r + 64, ... of column i (a warp reads 32
// neighbouring columns of one partial: whole lines), then one thread adds
// the 32 subsequence sums r = 0, 1, ... Blocks run in no order, so each
// writes its own partial and this pass adds them: no atomics, the same bits
// on every run. Static: each .cu file (compiled without relocatable device
// code) launches its own copy.
static __global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                              float* __restrict__ out, int nparts, int n,
                                              double scale) {
  __shared__ double sub[32][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  double acc = 0.0;
  if (i < n)
    for (int p = threadIdx.y; p < nparts; p += 32) acc += (double)partial[(size_t)p * n + i];
  sub[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || i >= n) return;
  double total = 0.0;
  for (int r = 0; r < 32; ++r) total += sub[r][threadIdx.x];
  out[i] = (float)(total * scale);
}

static inline cudaError_t reduce_partials(const float* partial, float* out, int nparts, int n,
                                          cudaStream_t stream, double scale = 1.0) {
  reduce_partials_kernel<<<(n + 31) / 32, dim3(32, 32), 0, stream>>>(partial, out, nparts, n,
                                                                     scale);
  return cudaGetLastError();
}

}  // namespace fno
