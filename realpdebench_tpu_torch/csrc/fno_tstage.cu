// T-stage of the fused FNO layer: the linear map along T on packed spectra,
//   out[b, k] = sum_t MR[t, k] * y[b, t] + MI[t, k] * swap(y[b, t]),
// where swap maps the lane halves [yr | yi] to [-yi | yr]: a complex
// multiply by (MR + i MI) in the (re | im, c) lane packing.
//
// Replaces realpdebench_tpu/ops/pallas/fno_layer.py::t_stage
// (_tstage_mxu_kernel / _tstage_vpu_kernel).
//
//   y   [B*Tin, Y, 2C]  (T)
//   mr, mi [Tin, Tout]  (f32)   passed in, so the forward T-DFT (et), the
//                               inverse (it) and their adjoints share it
//   out [B*Tout, Y, 2C] (T)
//
// What bounds it on an H100: bytes. At rollout width a launch moves 27 MB
// (8 us at 3.35 TB/s) and does 0.33 GFLOP; a launch's own latency is of the
// same order, so the card is fed only if every element crosses once, in
// whole 128-byte lines, with many loads in flight.
//
// Two variants, chosen from the shapes before the launch (ops/kernels.py::
// t_stage_variant):
//
//  * registers (min(Tin, Tout) <= 16, C a multiple of 4): a thread owns the
//    (b, row) column of 4 neighbouring channels and produces all Tout
//    outputs of it. The shorter side of T stays in registers: where
//    Tin >= Tout the 2*Tout accumulators of each channel, with the inputs
//    streamed in batches of kBatch independent vector loads; where
//    Tin < Tout the 2*Tin inputs, with the outputs streamed. Each element of
//    y is loaded once and each element of out stored once; re and im of a
//    channel lie C lanes apart, so the vector runs over channels and a
//    warp's request covers whole lines. (MR, MI) sit in shared memory as
//    float2, zero-padded to the instantiated register count R (4, 8 or 16),
//    read as warp-uniform broadcasts: one shared load per 16 FMAs. The
//    sums run over t in ascending order, as in the generic variant.
//  * generic (any other shape): one thread per output complex value, which
//    re-reads its column's Tin inputs through L1/L2.
#include <cstdint>

#include "fno_common.cuh"

namespace {

constexpr int kThreads = 256;     // generic variant
constexpr int kRegThreads = 128;  // registers variant
constexpr int kVec = 4;           // channels per thread, registers variant

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tstage_kernel(const T* __restrict__ y, const float* __restrict__ mr,
                  const float* __restrict__ mi, T* __restrict__ out, long long total, int Tin,
                  int Tout, int Y, int C) {
  extern __shared__ float smem[];
  float* smr = smem;  // [Tin][Tout]
  float* smi = smem + Tin * Tout;
  for (int i = threadIdx.x; i < Tin * Tout; i += blockDim.x) {
    smr[i] = mr[i];
    smi[i] = mi[i];
  }
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long r = idx / C;
  const int row = (int)(r % Y);
  r /= Y;
  const int k = (int)(r % Tout);
  const long long bb = r / Tout;
  const size_t tstride = (size_t)Y * 2 * C;
  const T* src = y + (size_t)bb * Tin * tstride + (size_t)row * 2 * C + c;
  float o_r = 0.f, o_i = 0.f;
  for (int t = 0; t < Tin; ++t) {
    const float yr = fno::to_f32(src[t * tstride]);
    const float yi = fno::to_f32(src[t * tstride + C]);
    const float pr = smr[t * Tout + k];
    const float pi = smi[t * Tout + k];
    o_r = fmaf(pr, yr, fmaf(-pi, yi, o_r));
    o_i = fmaf(pr, yi, fmaf(pi, yr, o_i));
  }
  T* dst = out + ((size_t)(bb * Tout + k) * Y + row) * 2 * C + c;
  dst[0] = fno::from_f32<T>(o_r);
  dst[C] = fno::from_f32<T>(o_i);
}

// kVec neighbouring channels as one vector load or store, kept raw so that a
// batch of loads is in flight before the first conversion.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[kVec]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[kVec]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[kVec]) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[kVec]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    Raw r;
    r.x = *reinterpret_cast<const unsigned*>(&a);
    r.y = *reinterpret_cast<const unsigned*>(&b);
    return r;
  }
};

// acc += (m.x + i m.y) * (yr + i yi), in the generic variant's FMA order.
__device__ __forceinline__ void cfma(const float2 m, const float (&yr)[kVec],
                                     const float (&yi)[kVec], float (&ar)[kVec],
                                     float (&ai)[kVec]) {
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    ar[v] = fmaf(m.x, yr[v], fmaf(-m.y, yi[v], ar[v]));
    ai[v] = fmaf(m.x, yi[v], fmaf(m.y, yr[v], ai[v]));
  }
}

// Registers variant. REDUCE (Tout <= R, Tin streamed): table [Tin][R],
// accumulators in registers. Otherwise (Tin <= R, Tout streamed): table
// [Tout][R], inputs in registers.
template <typename T, int R, bool REDUCE>
__global__ void __launch_bounds__(kRegThreads)
    tstage_reg_kernel(const T* __restrict__ y, const float* __restrict__ mr,
                      const float* __restrict__ mi, T* __restrict__ out, long long total,
                      int Tin, int Tout, int Y, int C) {
  using Raw = typename Vec<T>::Raw;
  // input planes whose (re, im) loads are started before the first is used
  constexpr int kBatch = (sizeof(T) == 2 ? 8 : 4) / (R > 8 ? 2 : 1);
  extern __shared__ float2 tab[];  // [streamed side][R], (MR, MI), zero beyond the short side
  const int nlong = REDUCE ? Tin : Tout;
  const int nshort = REDUCE ? Tout : Tin;
  for (int i = threadIdx.x; i < nlong * R; i += blockDim.x) {
    const int l = i / R, r = i - l * R;
    const int t = REDUCE ? l : r, k = REDUCE ? r : l;
    tab[i] = r < nshort ? make_float2(mr[t * Tout + k], mi[t * Tout + k]) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int groups = C / kVec;
  const long long per_b = (long long)Y * groups;
  const long long bb = idx / per_b;
  const int p = (int)(idx - bb * per_b);
  const int row = p / groups, cg = p - row * groups;
  const size_t plane = (size_t)Y * 2 * C;  // one t of one b
  const size_t col = (size_t)row * 2 * C + (size_t)cg * kVec;
  const T* src = y + (size_t)bb * Tin * plane + col;
  T* dst = out + (size_t)bb * Tout * plane + col;

  if constexpr (REDUCE) {
    float ar[R][kVec], ai[R][kVec];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int v = 0; v < kVec; ++v) ar[k][v] = ai[k][v] = 0.f;
    for (int t0 = 0; t0 < Tin; t0 += kBatch) {
      Raw rr[kBatch], ri[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t0 + u < Tin) {
          rr[u] = *reinterpret_cast<const Raw*>(src + (size_t)(t0 + u) * plane);
          ri[u] = *reinterpret_cast<const Raw*>(src + (size_t)(t0 + u) * plane + C);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t0 + u < Tin) {
          float yr[kVec], yi[kVec];
          Vec<T>::unpack(rr[u], yr);
          Vec<T>::unpack(ri[u], yi);
          const float2* m = tab + (t0 + u) * R;
#pragma unroll
          for (int k = 0; k < R; ++k) cfma(m[k], yr, yi, ar[k], ai[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k < Tout) {
        *reinterpret_cast<Raw*>(dst + (size_t)k * plane) = Vec<T>::pack(ar[k]);
        *reinterpret_cast<Raw*>(dst + (size_t)k * plane + C) = Vec<T>::pack(ai[k]);
      }
    }
  } else {
    float yr[R][kVec], yi[R][kVec];
    {
      Raw rr[R], ri[R];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        if (t < Tin) {
          rr[t] = *reinterpret_cast<const Raw*>(src + (size_t)t * plane);
          ri[t] = *reinterpret_cast<const Raw*>(src + (size_t)t * plane + C);
        }
      }
#pragma unroll
      for (int t = 0; t < R; ++t) {
        if (t < Tin) {
          Vec<T>::unpack(rr[t], yr[t]);
          Vec<T>::unpack(ri[t], yi[t]);
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) yr[t][v] = yi[t][v] = 0.f;
        }
      }
    }
    for (int k = 0; k < Tout; ++k) {
      float o_r[kVec], o_i[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) o_r[v] = o_i[v] = 0.f;
      const float2* m = tab + k * R;
#pragma unroll
      for (int t = 0; t < R; ++t) cfma(m[t], yr[t], yi[t], o_r, o_i);
      *reinterpret_cast<Raw*>(dst + (size_t)k * plane) = Vec<T>::pack(o_r);
      *reinterpret_cast<Raw*>(dst + (size_t)k * plane + C) = Vec<T>::pack(o_i);
    }
  }
}

template <typename T>
cudaError_t launch_generic(const void* y, const void* mr, const void* mi, void* out, int B,
                           int Tin, int Tout, int Y, int C, cudaStream_t stream) {
  const long long total = (long long)B * Tout * Y * C;
  const size_t smem = sizeof(float) * 2 * (size_t)Tin * Tout;
  cudaError_t err = fno::allow_smem(tstage_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  tstage_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(mr), static_cast<const float*>(mi),
      static_cast<T*>(out), total, Tin, Tout, Y, C);
  return cudaGetLastError();
}

template <typename T, int R, bool REDUCE>
cudaError_t launch_reg_as(const void* y, const void* mr, const void* mi, void* out, int B,
                          int Tin, int Tout, int Y, int C, cudaStream_t stream) {
  const long long total = (long long)B * Y * (C / kVec);
  const size_t smem = sizeof(float2) * (size_t)R * (REDUCE ? Tin : Tout);
  cudaError_t err = fno::allow_smem(tstage_reg_kernel<T, R, REDUCE>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((total + kRegThreads - 1) / kRegThreads);
  tstage_reg_kernel<T, R, REDUCE><<<blocks, kRegThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(mr), static_cast<const float*>(mi),
      static_cast<T*>(out), total, Tin, Tout, Y, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reg(const void* y, const void* mr, const void* mi, void* out, int B, int Tin,
                       int Tout, int Y, int C, cudaStream_t stream) {
  const int r = Tin < Tout ? Tin : Tout;
  if (r > 16 || C % kVec) return cudaErrorInvalidValue;
  // vector accesses: 8 bytes (bf16) or 16 bytes (f32)
  const uintptr_t align = sizeof(T) * kVec;
  if ((uintptr_t)y % align || (uintptr_t)out % align) return cudaErrorMisalignedAddress;
#define TSTAGE_REG(R)                                                                      \
  return Tout <= Tin ? launch_reg_as<T, R, true>(y, mr, mi, out, B, Tin, Tout, Y, C, stream) \
                     : launch_reg_as<T, R, false>(y, mr, mi, out, B, Tin, Tout, Y, C, stream)
  if (r <= 4) TSTAGE_REG(4);
  if (r <= 8) TSTAGE_REG(8);
  TSTAGE_REG(16);
#undef TSTAGE_REG
}

}  // namespace

// variant: 0 generic, 1 registers (ops/kernels.py: TSTAGE_VARIANTS). The
// caller chooses; a variant that does not take the shape returns an error.
extern "C" int fno_tstage(const void* y, const void* mr, const void* mi, void* out, int B,
                          int Tin, int Tout, int Y, int C, int variant, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Tin < 1 || Tout < 1 || Y < 1 || C < 1) return cudaErrorInvalidValue;
  if (dtype != fno::kF32 && dtype != fno::kBF16) return cudaErrorInvalidValue;
  const bool f32 = dtype == fno::kF32;
  if (variant == 0)
    return f32 ? launch_generic<float>(y, mr, mi, out, B, Tin, Tout, Y, C, s)
               : launch_generic<__nv_bfloat16>(y, mr, mi, out, B, Tin, Tout, Y, C, s);
  if (variant == 1)
    return f32 ? launch_reg<float>(y, mr, mi, out, B, Tin, Tout, Y, C, s)
               : launch_reg<__nv_bfloat16>(y, mr, mi, out, B, Tin, Tout, Y, C, s);
  return cudaErrorInvalidValue;
}
