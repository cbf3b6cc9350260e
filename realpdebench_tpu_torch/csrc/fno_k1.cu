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
// What bounds it on an H100: bytes. At rollout width (BT 208, Hp 70, Wp 134,
// C 64, m3 16, 2*m2 24) a launch reads 250 MB of x and writes 20 MB of y
// (0.081 ms at 3.35 TB/s); its 10.9 GFLOP (8 in the W contraction, 3 in the
// H fold) take 0.011 ms on the tensor cores, but 0.16 ms at the FP32 peak,
// and the first version, on FP32 FMAs with both operands of every FMA from
// shared memory, ran at 3% of the bound.
//
// Three variants, chosen from dtype, shape and alignment before the launch
// (ops/kernels.py::k1_variant):
//
//  * mma (bf16; C a multiple of 16, m3 in {8, 16}, 2*m2 <= 32, Wp <= 256,
//    16-byte aligned x): both contractions on mma.sync m16n8k16 (mma.cuh),
//    f32 accumulators, in the (W, H) DFT body that K2A-lite's mma variant
//    shares (fno_dft_mma.cuh): a block per (bt, 16-channel slice), 8 warps,
//    a warp per row of H with its own two-stage cp.async ring, the W product
//    and the H fold on mma.sync; the affine and the activation act on the
//    W product's B fragments.
//    Rounding: z, the DFT factors and X are bf16 operands, once each,
//    as JAX's _dot rounds both operands of each of K1's products to
//    bf16 (ops/pallas/fno_layer.py:292-303); the sums are f32 and y
//    rounds once on the write. Nothing of K1 feeds an f32 sum the port
//    holds to 1e-4 (its output is rounded to bf16), so no operand needs
//    the hi + lo pair that K2 and K12B take.
//    Shared memory at m3 16, Wp 134: 100 KB, two blocks (16 warps) an SM.
//  * tf32 (f32 tensors at the mma variant's shapes and alignment): the same
//    body in f32 on the tensor cores as 3xTF32 (fno_dft_tf32.cuh: every
//    product hi.hi + hi.lo + lo.hi on mma.sync m16n8k8, each f32 operand
//    split into its tf32 pair in registers), on the f32 tables of
//    ops/fno_layer.py::_k1_tables_on. Rounding points: z = act(a*x + b) in
//    f32 (the exact GELU through fno::erf_fast, A&S 7.1.26, |error| <= 3e-7,
//    about 3xTF32's own error), EW split once as the block stages it, X
//    kept in f32 in shared memory between the W product and the H fold, y
//    written in f32; each operand carries 22 bits, the sums are f32. The
//    ring holds pieces of 32 rows of W, not whole rows: 102528 bytes a block
//    at m3 16, Wp 134, two blocks (16 warps) an SM (whole f32 rows would take
//    147 KB for the rings alone, one block an SM). ptxas (-Xptxas -v,
//    sm_90a): 121 registers, no spills at <16, 3>; 128 and 132 bytes of
//    spill stores at fsi's <16, 4>.
//  * fma (f32 tensors at other shapes, misaligned views, and bf16 when
//    named): one block per (bt, 16-channel slice);
//    thread (c, m) owns one W mode of one channel. For each row h the block
//    stages z[h, :, slice] in shared memory, each thread contracts it against
//    its W-mode column and folds the result into its 2*m2 complex H-mode
//    accumulators (registers). x is read once, y written once; exact f32.
#include <cstdint>
#include <initializer_list>

#include "fno_common.cuh"
#include "fno_dft_mma.cuh"
#include "fno_dft_tf32.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core variant: the shared (W, H) DFT body of fno_dft_mma.cuh with
// the affine and activation on its input and the plain store of y
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using dftmma::kSlice;

inline int k1_mma_smem(int Wp, int m3) { return dftmma::body_smem(Wp, m3); }

template <int M3, int MTH>
__global__ void __launch_bounds__(dftmma::kWarps * 32, 2)
    k1_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const bf16* __restrict__ ew,
                  const bf16* __restrict__ eh, bf16* __restrict__ y, int Hp, int Wp, int C,
                  int m2x2, int act) {
  dftmma::wh_mma_body<M3, MTH, true>(x, a, b, ew, eh, dftmma::StoreY<M3, MTH, bf16>{y, C, m2x2},
                                     Hp, Wp, C, m2x2, act);
}

template <int M3, int MTH>
cudaError_t launch_k1_mma_as(const void* x, const void* a, const void* b, const void* ew,
                             const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2,
                             int act, cudaStream_t stream) {
  auto kernel = k1_mma_kernel<M3, MTH>;
  const int smem = k1_mma_smem(Wp, M3);
  cudaError_t err = fno::allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(C / kSlice, BT), dftmma::kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(ew), static_cast<const bf16*>(eh), static_cast<bf16*>(y), Hp, Wp,
      C, m2x2, act);
  return cudaGetLastError();
}

cudaError_t launch_k1_mma(const void* x, const void* a, const void* b, const void* ew,
                          const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2,
                          int m3, int act, cudaStream_t stream) {
  if (C % kSlice || m2x2 < 1 || m2x2 > 32 || Wp > 256 || BT > 65535 || ew == nullptr ||
      eh == nullptr || k1_mma_smem(Wp, m3) > 232448)
    return cudaErrorInvalidValue;
  for (const void* p : {x, ew, eh, (const void*)y})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int mth = (2 * m2x2 + 15) / 16;
#define K1_MMA(MM, MT)                                                                        \
  if (m3 == MM && mth == MT)                                                                  \
  return launch_k1_mma_as<MM, MT>(x, a, b, ew, eh, y, BT, Hp, Wp, C, m2x2, act, stream)
  K1_MMA(16, 3);   // the cylinder: 2*m2 = 24
  K1_MMA(16, 4);   // fsi, combustion: 2*m2 = 32
  K1_MMA(16, 1);
  K1_MMA(16, 2);
  K1_MMA(8, 1);
  K1_MMA(8, 2);
  K1_MMA(8, 3);
  K1_MMA(8, 4);
#undef K1_MMA
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The tf32 variant: fno_dft_tf32.cuh's body, the affine and activation on its
// input and the plain store of y
// ---------------------------------------------------------------------------

inline int k1_tf32_smem(int Wp, int m3) { return dfttf32::body_smem(Wp, m3); }

template <int M3, int MTH>
__global__ void __launch_bounds__(dfttf32::kWarps * 32, 2)
    k1_tf32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ ew,
                   const float* __restrict__ eh, float* __restrict__ y, int Hp, int Wp, int C,
                   int m2x2, int act) {
  dfttf32::wh_tf32_body<M3, MTH, true>(x, a, b, ew, eh, dftmma::StoreY<M3, MTH, float>{y, C, m2x2},
                                       Hp, Wp, C, act);
}

template <int M3, int MTH>
cudaError_t launch_k1_tf32_as(const void* x, const void* a, const void* b, const void* ew,
                              const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2,
                              int act, cudaStream_t stream) {
  auto kernel = k1_tf32_kernel<M3, MTH>;
  const int smem = k1_tf32_smem(Wp, M3);
  cudaError_t err = fno::allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(C / dfttf32::kSlice, BT), dfttf32::kWarps * 32, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(ew), static_cast<const float*>(eh), static_cast<float*>(y), Hp,
      Wp, C, m2x2, act);
  return cudaGetLastError();
}

cudaError_t launch_k1_tf32(const void* x, const void* a, const void* b, const void* ew,
                           const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2,
                           int m3, int act, cudaStream_t stream) {
  if (C % dfttf32::kSlice || m2x2 < 1 || m2x2 > 32 || Wp > 256 || BT > 65535 ||
      ew == nullptr || eh == nullptr || k1_tf32_smem(Wp, m3) > 232448)
    return cudaErrorInvalidValue;
  for (const void* p : {x, ew, eh, (const void*)y})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int mth = (2 * m2x2 + 15) / 16;
#define K1_TF32(MM, MT)                                                                       \
  if (m3 == MM && mth == MT)                                                                  \
  return launch_k1_tf32_as<MM, MT>(x, a, b, ew, eh, y, BT, Hp, Wp, C, m2x2, act, stream)
  K1_TF32(16, 3);   // the cylinder: 2*m2 = 24
  K1_TF32(16, 4);   // fsi, combustion: 2*m2 = 32
  K1_TF32(16, 1);
  K1_TF32(16, 2);
  K1_TF32(8, 1);
  K1_TF32(8, 2);
  K1_TF32(8, 3);
  K1_TF32(8, 4);
#undef K1_TF32
  return cudaErrorInvalidValue;
}

}  // namespace

// Text of a cudaError_t code returned by any entry point of the library.
extern "C" const char* fno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of shared memory a block of the mma variant takes.
extern "C" int fno_k1_mma_smem_bytes(int Wp, int m3) { return k1_mma_smem(Wp, m3); }

// Bytes of shared memory a block of the tf32 variant takes.
extern "C" int fno_k1_tf32_smem_bytes(int Wp, int m3) { return k1_tf32_smem(Wp, m3); }

// variant: 0 fma, 1 mma, 2 tf32 (ops/kernels.py: VARIANTS["k1"]); ew, eh: the
// DFT tables of the mma variant (bf16) or of the tf32 variant (f32), null for
// fma. A variant that does not take the dtype or shape returns an error.
extern "C" int fno_k1(const void* x, const void* a, const void* b, const void* ewr,
                      const void* ewi, const void* ehr, const void* ehi, const void* ew,
                      const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2, int m3,
                      int act, int variant, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BT < 1 || Hp < 1 || Wp < 1 || C < 1 || m3 < 1) return cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != fno::kBF16) return cudaErrorInvalidValue;
    return launch_k1_mma(x, a, b, ew, eh, y, BT, Hp, Wp, C, m2x2, m3, act, s);
  }
  if (variant == 2) {
    if (dtype != fno::kF32) return cudaErrorInvalidValue;
    return launch_k1_tf32(x, a, b, ew, eh, y, BT, Hp, Wp, C, m2x2, m3, act, s);
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == fno::kF32)
    return launch_k1<float>(x, a, b, ewr, ewi, ehr, ehi, y, BT, Hp, Wp, C, m2x2, m3, act, s);
  if (dtype == fno::kBF16)
    return launch_k1<__nv_bfloat16>(x, a, b, ewr, ewi, ehr, ehi, y, BT, Hp, Wp, C, m2x2, m3,
                                    act, s);
  return cudaErrorInvalidValue;
}
