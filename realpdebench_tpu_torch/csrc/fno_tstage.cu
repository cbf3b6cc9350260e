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
// Design: one thread per output complex value (b, k, row, c); it reads the
// Tin (re, im) pairs of its (b, row, c) column, neighbouring threads on
// neighbouring channels. MR/MI sit in shared memory. Bound: ~10 M elements
// at rollout width and 4*Tin flops per output pair, so HBM traffic bounds
// it; the Tout-fold re-reads of a column hit L2 (one batch's spectra are
// ~2.5 MB).
#include "fno_common.cuh"

namespace {

constexpr int kThreads = 256;

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

template <typename T>
cudaError_t launch_tstage(const void* y, const void* mr, const void* mi, void* out, int B,
                          int Tin, int Tout, int Y, int C, cudaStream_t stream) {
  if (B < 1 || Tin < 1 || Tout < 1 || Y < 1 || C < 1) return cudaErrorInvalidValue;
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

}  // namespace

extern "C" int fno_tstage(const void* y, const void* mr, const void* mi, void* out, int B,
                          int Tin, int Tout, int Y, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fno::kF32) return launch_tstage<float>(y, mr, mi, out, B, Tin, Tout, Y, C, s);
  if (dtype == fno::kBF16)
    return launch_tstage<__nv_bfloat16>(y, mr, mi, out, B, Tin, Tout, Y, C, s);
  return cudaErrorInvalidValue;
}
