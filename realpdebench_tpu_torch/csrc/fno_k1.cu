// K1 of the fused FNO layer: z = act(a*x + b), then the truncated forward
// DFT of z over W (m3 rfft modes) and over H (2*m2 kept modes).
//
// Replaces realpdebench_tpu/ops/pallas/fno_layer.py::_k1_kernel.
//
//   x  [BT, Hp, Wp, C]  (T)     activations, channels minor
//   a, b [C]            (f32)   previous layer's folded BatchNorm
//   ewr, ewi [Wp, m3]   (f32)   forward W DFT (cos, -sin)
//   ehr, ehi [Hp, 2m2]  (f32)   forward H DFT on the kept modes
//   y  [BT, 2m2*m3, 2C] (T)     rows (j2, m), lanes (re | im, c)
//
// Design: one block per (bt, 16-channel slice); thread (c, m) owns one W
// mode of one channel. For each row h the block stages z[h, :, slice] in
// shared memory, each thread contracts it against its W-mode column, and
// folds the result into its 2*m2 complex H-mode accumulators (registers).
// x is read once, y written once. Bound: at rollout width one layer reads
// ~250 MB (bf16) and does ~11 GFLOP (8 of them in the W contraction) in f32
// on CUDA cores, so the FP32 pipe (and the shared-memory loads feeding it)
// bound it, not HBM; tensor cores (wgmma on a [z-row x DFT-factor] product)
// are the next step.
#include "fno_common.cuh"

namespace {

constexpr int kMaxJ2 = 32;  // 2*m2 upper bound: the H accumulators live in registers

template <typename T>
__global__ void k1_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ b, const float* __restrict__ ewr,
                          const float* __restrict__ ewi, const float* __restrict__ ehr,
                          const float* __restrict__ ehi, T* __restrict__ y, int Hp, int Wp,
                          int C, int m2x2, int m3, int act) {
  extern __shared__ float smem[];
  const int CT = blockDim.x;
  const int nthr = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * CT + threadIdx.x;
  float* zrow = smem;              // [Wp][CT]
  float* sw_r = zrow + Wp * CT;    // [Wp][m3]
  float* sw_i = sw_r + Wp * m3;
  float* sh_r = sw_i + Wp * m3;    // [Hp][m2x2]
  float* sh_i = sh_r + Hp * m2x2;
  float* sa = sh_i + Hp * m2x2;    // [CT]
  float* sb = sa + CT;

  const int bt = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  for (int i = tid; i < Wp * m3; i += nthr) {
    sw_r[i] = ewr[i];
    sw_i[i] = ewi[i];
  }
  for (int i = tid; i < Hp * m2x2; i += nthr) {
    sh_r[i] = ehr[i];
    sh_i[i] = ehi[i];
  }
  for (int i = tid; i < CT; i += nthr) {
    sa[i] = a[c0 + i];
    sb[i] = b[c0 + i];
  }

  const int cl = threadIdx.x;
  const int m = threadIdx.y;
  float acc_r[kMaxJ2], acc_i[kMaxJ2];
#pragma unroll
  for (int j = 0; j < kMaxJ2; ++j) {
    acc_r[j] = 0.f;
    acc_i[j] = 0.f;
  }
  const T* xb = x + (size_t)bt * Hp * Wp * C + c0;
  for (int h = 0; h < Hp; ++h) {
    __syncthreads();  // constants staged; the previous row is consumed
    const T* xh = xb + (size_t)h * Wp * C;
    for (int i = tid; i < Wp * CT; i += nthr) {
      const int w = i / CT;
      const int cc = i - w * CT;
      zrow[i] = fno::affine_act(fno::to_f32(xh[(size_t)w * C + cc]), sa[cc], sb[cc], act);
    }
    __syncthreads();
    float sr = 0.f, si = 0.f;
    for (int w = 0; w < Wp; ++w) {
      const float z = zrow[w * CT + cl];
      sr = fmaf(z, sw_r[w * m3 + m], sr);
      si = fmaf(z, sw_i[w * m3 + m], si);
    }
#pragma unroll
    for (int j = 0; j < kMaxJ2; ++j) {
      if (j < m2x2) {
        const float er = sh_r[h * m2x2 + j];
        const float ei = sh_i[h * m2x2 + j];
        acc_r[j] = fmaf(sr, er, fmaf(-si, ei, acc_r[j]));
        acc_i[j] = fmaf(sr, ei, fmaf(si, er, acc_i[j]));
      }
    }
  }
  T* yb = y + (size_t)bt * m2x2 * m3 * 2 * C + c0 + cl;
#pragma unroll
  for (int j = 0; j < kMaxJ2; ++j) {
    if (j < m2x2) {
      T* row = yb + (size_t)(j * m3 + m) * 2 * C;
      row[0] = fno::from_f32<T>(acc_r[j]);
      row[C] = fno::from_f32<T>(acc_i[j]);
    }
  }
}

template <typename T>
cudaError_t launch_k1(const void* x, const void* a, const void* b, const void* ewr,
                      const void* ewi, const void* ehr, const void* ehi, void* y, int BT,
                      int Hp, int Wp, int C, int m2x2, int m3, int act, cudaStream_t stream) {
  const int CT = C < 16 ? C : 16;
  if (C % CT != 0 || m2x2 > kMaxJ2 || m2x2 < 1 || m3 < 1 || CT * m3 > 1024)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)Wp * CT + 2 * (size_t)Wp * m3 +
                                       2 * (size_t)Hp * m2x2 + 2 * (size_t)CT);
  cudaError_t err = fno::allow_smem(k1_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BT, C / CT);
  const dim3 block(CT, m3);
  k1_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(ewr), static_cast<const float*>(ewi),
      static_cast<const float*>(ehr), static_cast<const float*>(ehi), static_cast<T*>(y), Hp,
      Wp, C, m2x2, m3, act);
  return cudaGetLastError();
}

}  // namespace

// Text of a cudaError_t code returned by any entry point of the library.
extern "C" const char* fno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int fno_k1(const void* x, const void* a, const void* b, const void* ewr,
                      const void* ewi, const void* ehr, const void* ehi, void* y, int BT,
                      int Hp, int Wp, int C, int m2x2, int m3, int act, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fno::kF32)
    return launch_k1<float>(x, a, b, ewr, ewi, ehr, ehi, y, BT, Hp, Wp, C, m2x2, m3, act, s);
  if (dtype == fno::kBF16)
    return launch_k1<__nv_bfloat16>(x, a, b, ewr, ewi, ehr, ehi, y, BT, Hp, Wp, C, m2x2, m3,
                                    act, s);
  return cudaErrorInvalidValue;
}
