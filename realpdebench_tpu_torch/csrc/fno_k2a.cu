// K2A and K2A-lite of the fused FNO layer's backward: the spectral cotangent
//   dg = A(ds + ds1 + 2*ds2*s),
// where A is the adjoint of K2's inverse (H, W) DFT and (ds1, ds2) [C] are
// the cotangents of K2's BatchNorm statistics (sum, sum of squares).
//
// Replaces realpdebench_tpu/ops/pallas/fno_layer.py::_k2a_kernel (full
// read) and ::_k2a_lite_kernel, with their shared _k2a_adjoint_write.
//
//   full (K2A):      reads ds and s, applies A to ds_eff = ds + ds1 + 2 ds2 s.
//   lite (K2A-lite): reads ds only and adds the A(s) part from the saved
//                    mode-space tensors g (the layer's spectra) and y (K1's
//                    output):  dg = A(ds) + ds1*A1 + 2 ds2*(M g + D*(y@Wp) + bp*A1),
//                    with M g = alpha*g + beta*g[kh mirror] (ops/fno_layer.py::
//                    _lite_consts derives alpha, beta, D, A1 from the port's DFT
//                    factors and checks the identity).
//
//   ds, s [BT, Hp, Wp, C] (T);   g, y [BT, 2m2*m3, 2C] (T)
//   v1 [C]   full: ds1;  lite: ds1 + 2 ds2 bp       (f32)
//   two [C]  2*ds2                                   (f32)
//   wps [C, C]  lite: Wp with column c scaled by 2 ds2[c]  (f32)
//   alpha, beta, D, A1 [Y, 2]  lite statics          (f32)
//   ihr, ihi [2m2, Hp], iwr, iwi [m3, Wp]            K2's inverse factors (f32)
//   dg [BT, 2m2*m3, 2C] (T)
//
// Design: K1's shape, run on the adjoint factors. One block per (bt,
// 16-channel slice); thread (c, m) owns one W mode of one channel. For each
// row h the block stages the row of ds (ds_eff in the full mode) in shared
// memory, each thread contracts it against its inverse-W row, and folds the
// result into its 2*m2 complex H-mode accumulators held in registers. ds
// (and s) are read once, dg written once. The lite mode's correction is
// mode-space work per (bt): two scalings, a row mirror and one [Y*2, C] x
// [C, C] product on CUDA cores (Wp in shared memory). Bound: like K1, one
// pass over a full activation (~1 GB bf16 at training width, 2 GB for the
// full mode) and ~11 GFLOP per 208 rows of BT in f32 on CUDA cores, so the
// FP32 pipe and its shared-memory operand loads bound it; the lite mode
// trades the second full-size read for ~1.3 GFLOP per 208 rows.
#include "fno_common.cuh"

namespace {

constexpr int kMaxJ2 = 32;  // 2*m2 upper bound: the H accumulators live in registers

template <typename T, bool kLite>
__global__ void k2a_kernel(const T* __restrict__ ds, const T* __restrict__ s,
                           const T* __restrict__ g, const T* __restrict__ y,
                           const float* __restrict__ v1, const float* __restrict__ two,
                           const float* __restrict__ wps, const float* __restrict__ alpha,
                           const float* __restrict__ beta, const float* __restrict__ D,
                           const float* __restrict__ A1, const float* __restrict__ ihr,
                           const float* __restrict__ ihi, const float* __restrict__ iwr,
                           const float* __restrict__ iwi, T* __restrict__ dg, int Hp, int Wp,
                           int C, int m2x2, int m3) {
  extern __shared__ float smem[];
  const int CT = blockDim.x;
  const int nthr = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * CT + threadIdx.x;
  float* drow = smem;              // [Wp][CT]
  float* siw_r = drow + Wp * CT;   // [m3][Wp]
  float* siw_i = siw_r + m3 * Wp;
  float* sih_r = siw_i + m3 * Wp;  // [m2x2][Hp]
  float* sih_i = sih_r + m2x2 * Hp;
  float* sv1 = sih_i + m2x2 * Hp;  // [CT]
  float* stwo = sv1 + CT;
  float* swps = stwo + CT;         // lite: [C][CT]

  const int bt = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  for (int i = tid; i < m3 * Wp; i += nthr) {
    siw_r[i] = iwr[i];
    siw_i[i] = iwi[i];
  }
  for (int i = tid; i < m2x2 * Hp; i += nthr) {
    sih_r[i] = ihr[i];
    sih_i[i] = ihi[i];
  }
  for (int i = tid; i < CT; i += nthr) {
    sv1[i] = v1[c0 + i];
    stwo[i] = two[c0 + i];
  }
  if (kLite) {
    for (int i = tid; i < C * CT; i += nthr) {
      const int c = i / CT;
      swps[i] = wps[c * C + c0 + (i - c * CT)];
    }
  }

  const int cl = threadIdx.x;
  const int m = threadIdx.y;
  float acc_r[kMaxJ2], acc_i[kMaxJ2];
#pragma unroll
  for (int j = 0; j < kMaxJ2; ++j) {
    acc_r[j] = 0.f;
    acc_i[j] = 0.f;
  }
  const size_t img = (size_t)bt * Hp * Wp * C + c0;
  for (int h = 0; h < Hp; ++h) {
    __syncthreads();  // constants staged; the previous row is consumed
    const size_t row = img + (size_t)h * Wp * C;
    for (int i = tid; i < Wp * CT; i += nthr) {
      const int w = i / CT;
      const int cc = i - w * CT;
      const size_t at = row + (size_t)w * C + cc;
      float d = fno::to_f32(ds[at]);
      if (!kLite) d += sv1[cc] + stwo[cc] * fno::to_f32(s[at]);
      drow[i] = d;
    }
    __syncthreads();
    float sr = 0.f, si = 0.f;
    for (int w = 0; w < Wp; ++w) {
      const float d = drow[w * CT + cl];
      sr = fmaf(d, siw_r[m * Wp + w], sr);
      si = fmaf(d, siw_i[m * Wp + w], si);
    }
#pragma unroll
    for (int j = 0; j < kMaxJ2; ++j) {
      if (j < m2x2) {
        const float er = sih_r[j * Hp + h];
        const float ei = sih_i[j * Hp + h];
        acc_r[j] = fmaf(sr, er, fmaf(si, ei, acc_r[j]));
        acc_i[j] = fmaf(si, er, fmaf(-sr, ei, acc_i[j]));
      }
    }
  }

  const int c = c0 + cl;
  const size_t C2 = 2 * (size_t)C;
  const size_t gb = (size_t)bt * m2x2 * m3 * C2;
#pragma unroll
  for (int j = 0; j < kMaxJ2; ++j) {
    if (j < m2x2) {
      const int Yr = j * m3 + m;
      float out[2] = {acc_r[j], acc_i[j]};
      if (kLite) {
        const int jm = j == 0 ? 0 : m2x2 - j;  // kh mirror of j
        const int Ym = jm * m3 + m;
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const size_t at = gb + Yr * C2 + ri * C;
          float yw = 0.f;  // (y @ wps)[Yr, ri, c]
          for (int cp = 0; cp < C; ++cp) yw = fmaf(fno::to_f32(y[at + cp]), swps[cp * CT + cl], yw);
          const float gm = Ym != Yr ? fno::to_f32(g[gb + Ym * C2 + ri * C + c]) : 0.f;
          const int k = Yr * 2 + ri;
          out[ri] += stwo[cl] * (alpha[k] * fno::to_f32(g[at + c]) + beta[k] * gm) +
                     D[k] * yw + sv1[cl] * A1[k];
        }
      }
      T* dst = dg + gb + Yr * C2 + c;
      dst[0] = fno::from_f32<T>(out[0]);
      dst[C] = fno::from_f32<T>(out[1]);
    }
  }
}

template <typename T, bool kLite>
cudaError_t launch_k2a(const void* ds, const void* s, const void* g, const void* y,
                       const void* v1, const void* two, const void* wps, const void* alpha,
                       const void* beta, const void* D, const void* A1, const void* ihr,
                       const void* ihi, const void* iwr, const void* iwi, void* dg, int BT,
                       int Hp, int Wp, int C, int m2x2, int m3, cudaStream_t stream) {
  const int CT = C < 16 ? C : 16;
  if (C % CT != 0 || m2x2 > kMaxJ2 || m2x2 < 1 || m3 < 1 || CT * m3 > 1024 || BT < 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)Wp * CT + 2 * (size_t)m3 * Wp + 2 * (size_t)m2x2 * Hp +
                       2 * (size_t)CT + (kLite ? (size_t)C * CT : 0));
  cudaError_t err = fno::allow_smem(k2a_kernel<T, kLite>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BT, C / CT);
  const dim3 block(CT, m3);
  k2a_kernel<T, kLite><<<grid, block, smem, stream>>>(
      static_cast<const T*>(ds), static_cast<const T*>(s), static_cast<const T*>(g),
      static_cast<const T*>(y), static_cast<const float*>(v1), static_cast<const float*>(two),
      static_cast<const float*>(wps), static_cast<const float*>(alpha),
      static_cast<const float*>(beta), static_cast<const float*>(D),
      static_cast<const float*>(A1), static_cast<const float*>(ihr),
      static_cast<const float*>(ihi), static_cast<const float*>(iwr),
      static_cast<const float*>(iwi), static_cast<T*>(dg), Hp, Wp, C, m2x2, m3);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int lite, const void* ds, const void* s, const void* g, const void* y,
                     const void* v1, const void* two, const void* wps, const void* alpha,
                     const void* beta, const void* D, const void* A1, const void* ihr,
                     const void* ihi, const void* iwr, const void* iwi, void* dg, int BT,
                     int Hp, int Wp, int C, int m2x2, int m3, cudaStream_t st) {
  if (lite)
    return launch_k2a<T, true>(ds, s, g, y, v1, two, wps, alpha, beta, D, A1, ihr, ihi, iwr,
                               iwi, dg, BT, Hp, Wp, C, m2x2, m3, st);
  return launch_k2a<T, false>(ds, s, g, y, v1, two, wps, alpha, beta, D, A1, ihr, ihi, iwr, iwi,
                              dg, BT, Hp, Wp, C, m2x2, m3, st);
}

}  // namespace

// lite = 0: K2A (reads ds, s; g, y, wps and the statics may be null).
// lite = 1: K2A-lite (reads ds, g, y; s may be null).
extern "C" int fno_k2a(const void* ds, const void* s, const void* g, const void* y,
                       const void* v1, const void* two, const void* wps, const void* alpha,
                       const void* beta, const void* D, const void* A1, const void* ihr,
                       const void* ihi, const void* iwr, const void* iwi, void* dg, int BT,
                       int Hp, int Wp, int C, int m2x2, int m3, int lite, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == fno::kF32)
    return dispatch<float>(lite, ds, s, g, y, v1, two, wps, alpha, beta, D, A1, ihr, ihi, iwr,
                           iwi, dg, BT, Hp, Wp, C, m2x2, m3, st);
  if (dtype == fno::kBF16)
    return dispatch<__nv_bfloat16>(lite, ds, s, g, y, v1, two, wps, alpha, beta, D, A1, ihr,
                                   ihi, iwr, iwi, dg, BT, Hp, Wp, C, m2x2, m3, st);
  return cudaErrorInvalidValue;
}
