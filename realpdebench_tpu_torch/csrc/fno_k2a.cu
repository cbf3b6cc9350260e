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
// trades the second full-size read for ~1.3 GFLOP per 208 rows. That FMA
// kernel stays as the lite mode's `fma` variant (other shapes, misaligned
// views, and bf16 or f32 when named) and as the full mode.
//
// The lite mode's `mma` variant (bf16; C a multiple of 16 up to 128, m3 in
// {8, 16}, 2*m2 <= 32, Wp <= 256, 16-byte aligned ds, g and y; chosen by
// ops/kernels.py::k2a_lite_variant): A(ds) is K1's contraction on other
// tables, so it runs K1's tensor-core body (fno_dft_mma.cuh) on
// IW = [iwr; iwi] and a packed H table that carries the adjoint's sign
// pattern (acc_r += sr*er + si*ei, acc_i += si*er - sr*ei; built by
// ops/fno_layer.py::_k2a_mma_tables), with no affine. The correction is the
// body's epilogue, before the one bf16 write of dg: the product y @ wps
// ([2Y, C] x [C, 16] per block) on mma.sync, y's A fragments read straight
// from global memory (bf16, exact) and the slice of wps rounded once to
// bf16 in shared memory; the elementwise terms in f32. The grid runs the
// C/16 slices of one bt as neighbouring blocks, so L2 serves the repeated
// reads of y[bt] and g[bt]. Rounding: ds is bf16, the tables and X round
// once, as in K1 and JAX's _dot; dg rounds once and feeds no f32 sum inside
// the kernel. Bound: bytes, ds's 1.0 GB at training width (0.37 ms); the
// products' 48.7 GFLOP take 0.05 ms on the tensor cores.
//
// The lite mode's `tf32` variant (f32 tensors at the mma variant's shapes and
// alignment): the same split on fno_dft_tf32.cuh's body, K1's tf32 body on
// the adjoint's f32 tables (ops/fno_layer.py::_k2a_tables_on: iw, and ih
// with the adjoint's sign pattern), no affine, every product 3xTF32 on
// mma.sync m16n8k8. The correction epilogue's y @ wps ([2Y, C] x [C, 16] a
// block) runs as 3xTF32 too: the slice of wps sits in shared memory in f32
// ([C][18]: the 32-bit loads of its [k][n] B fragments on 32 banks), split
// in registers; y's A fragments come from global memory, k permuted alike in
// A and B over pairs of k-steps so that a lane reads its four values of a
// row as one 16-byte load (as 32-bit loads, 16 bytes of each 32-byte
// sector, the loads took 0.85 of 2.25 ms on an H100 at BT 832 by
// tools/torch_tf32_probe.py, as 16-byte loads 0.18 of 1.61); the
// elementwise terms in f32, dg written in f32. As f32 FMAs from registers
// the product would be C multiply-adds an output, 1536 a lane of a warp's
// 48 x 32 outputs at C 64, against 288 MMAs (3 x 8 k-steps x 4 tiles x 3).
// Rounding points: ds, the tables, X (in f32 between the two products), y
// and wps each a tf32 pair, the sums f32. Shared memory: K1's 102528 bytes
// at m3 16, Wp 134, then wps, 4.5 KB at C 64 and 9 KB at C 128: 107136 and
// 111744 bytes, two blocks an SM at both widths. ptxas (-Xptxas -v, sm_90a):
// 122 registers at <16, 3>, 128 at <16, 4>, no spills.
#include <cstdint>
#include <initializer_list>

#include "fno_common.cuh"
#include "fno_dft_mma.cuh"
#include "fno_dft_tf32.cuh"

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

// ---------------------------------------------------------------------------
// K2A-lite's tensor-core variant
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using dftmma::kSlice;

constexpr int kWpsStride = 24;   // row stride of the wps slice in shared memory (bank spread)

// Bytes of shared memory (ops/kernels.py::k2a_lite_mma_smem_bytes): the DFT
// body's, then the block's slice of wps [C][16] as bf16.
inline int k2a_lite_mma_smem(int Wp, int m3, int C) {
  return dftmma::body_smem(Wp, m3) + C * kWpsStride * 2;
}

// dg = A(ds) + 2 ds2 (alpha g + beta g[kh mirror]) + D (y @ wps) + dsc A1
// from the body's accumulators A(ds) (see the K2A-lite note above; dsc =
// ds1 + 2 ds2 bp, two = 2 ds2, wps = Wp with column c scaled by two[c]).
template <int M3, int MTH>
struct LiteCorrection {
  static constexpr int NTH = 2 * M3 / 8;
  const bf16* __restrict__ g;
  const bf16* __restrict__ y;
  const float* __restrict__ dsc;
  const float* __restrict__ two;
  const float* __restrict__ wps;
  const float* __restrict__ alpha;
  const float* __restrict__ beta;
  const float* __restrict__ D;
  const float* __restrict__ A1;
  bf16* __restrict__ dg;
  int C, m2x2, smem_off;

  // the slice of wps, [C][16] rounded to bf16, after the body's shared memory
  __device__ __forceinline__ void stage(unsigned char* p, int tid) const {
    bf16* sw = reinterpret_cast<bf16*>(p);
    const int c0 = blockIdx.x * kSlice;
    for (int i = tid; i < C * kSlice; i += blockDim.x) {
      const int cp = i >> 4, c = i & 15;
      sw[cp * kWpsStride + c] = __float2bfloat16_rn(wps[(size_t)cp * C + c0 + c]);
    }
  }

  __device__ __forceinline__ void operator()(const float (&acc)[MTH][NTH][4], int bt, int c0,
                                             int warp, int lane) const {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const bf16* sw = reinterpret_cast<const bf16*>(smem_raw + smem_off);
    const int gq = lane >> 2, q = lane & 3;
    const size_t C2 = 2 * (size_t)C;
    const size_t img = (size_t)bt * m2x2 * M3 * C2;
    const int mbase = (warp * 2 * M3) >> 4;   // the warp's first W mode; it owns NTH / 2
#pragma unroll
    for (int mt = 0; mt < MTH; ++mt) {
      // yw[t] = y @ wps on rows (re|im, j) of this tile, columns (m, c) of tile t
      float yw[NTH][4];
#pragma unroll
      for (int t = 0; t < NTH; ++t) yw[t][0] = yw[t][1] = yw[t][2] = yw[t][3] = 0.f;
      for (int ks = 0; ks < C / 16; ++ks) {
        int k, n;
        mma::b_frag_row(lane, ks * 16, 0, k, n);
        uint32_t fb[4];
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(sw + k * kWpsStride + n));
#pragma unroll
        for (int mi = 0; mi < NTH / 2; ++mi) {
          const int m = mbase + mi;
          uint32_t fa[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int R = mt * 16 + gq + (r & 1) * 8;
            fa[r] = 0u;
            if (R < 2 * m2x2) {
              const int part = R / m2x2, j = R - part * m2x2;
              fa[r] = __ldg(reinterpret_cast<const unsigned int*>(
                  y + img + (size_t)(j * M3 + m) * C2 + part * C + ks * 16 + 2 * q + (r >> 1) * 8));
            }
          }
          mma::mma_bf16(yw[2 * mi], fa, fb[0], fb[1]);
          mma::mma_bf16(yw[2 * mi + 1], fa, fb[2], fb[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < NTH; ++t) {
        const int m = mbase + (t >> 1), cg = c0 + (t & 1) * 8 + 2 * q;
        const float tw0 = two[cg], tw1 = two[cg + 1], dc0 = dsc[cg], dc1 = dsc[cg + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int R = mt * 16 + gq + hf * 8;
          if (R >= 2 * m2x2) continue;
          const int part = R / m2x2, j = R - part * m2x2;
          const int Yr = j * M3 + m, k = Yr * 2 + part;
          const int jm = j == 0 ? 0 : m2x2 - j, Ym = jm * M3 + m;   // kh mirror of j
          const size_t at = img + (size_t)Yr * C2 + part * C + cg;
          const float2 gv = mma::unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(g + at)));
          float2 gm = make_float2(0.f, 0.f);
          if (Ym != Yr)
            gm = mma::unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(
                g + img + (size_t)Ym * C2 + part * C + cg)));
          const float al = alpha[k], be = beta[k], dk = D[k], a1 = A1[k];
          const float o0 = acc[mt][t][2 * hf] + tw0 * (al * gv.x + be * gm.x) +
                           dk * yw[t][2 * hf] + dc0 * a1;
          const float o1 = acc[mt][t][2 * hf + 1] + tw1 * (al * gv.y + be * gm.y) +
                           dk * yw[t][2 * hf + 1] + dc1 * a1;
          *reinterpret_cast<uint32_t*>(dg + at) = mma::pack_bf16(o0, o1);
        }
      }
    }
  }
};

template <int M3, int MTH>
__global__ void __launch_bounds__(dftmma::kWarps * 32, 2)
    k2a_lite_mma_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ iw,
                        const bf16* __restrict__ ih, LiteCorrection<M3, MTH> epi, int Hp, int Wp,
                        int C, int m2x2) {
  dftmma::wh_mma_body<M3, MTH, false>(ds, nullptr, nullptr, iw, ih, epi, Hp, Wp, C, m2x2,
                                      fno::kActNone);
}

template <int M3, int MTH>
cudaError_t launch_k2a_lite_mma_as(const void* ds, const void* g, const void* y, const void* dsc,
                                   const void* two, const void* wps, const void* alpha,
                                   const void* beta, const void* D, const void* A1,
                                   const void* iw, const void* ih, void* dg, int BT, int Hp,
                                   int Wp, int C, int m2x2, cudaStream_t stream) {
  auto kernel = k2a_lite_mma_kernel<M3, MTH>;
  const int smem = k2a_lite_mma_smem(Wp, M3, C);
  cudaError_t err = fno::allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const LiteCorrection<M3, MTH> epi{
      static_cast<const bf16*>(g),      static_cast<const bf16*>(y),
      static_cast<const float*>(dsc),   static_cast<const float*>(two),
      static_cast<const float*>(wps),   static_cast<const float*>(alpha),
      static_cast<const float*>(beta),  static_cast<const float*>(D),
      static_cast<const float*>(A1),    static_cast<bf16*>(dg),
      C, m2x2, dftmma::body_smem(Wp, M3)};
  // the C/16 slices of one bt are neighbouring blocks: y[bt] and g[bt] come
  // from L2 after the first
  kernel<<<dim3(C / kSlice, BT), dftmma::kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(ds), static_cast<const bf16*>(iw), static_cast<const bf16*>(ih),
      epi, Hp, Wp, C, m2x2);
  return cudaGetLastError();
}

cudaError_t launch_k2a_lite_mma(const void* ds, const void* g, const void* y, const void* dsc,
                                const void* two, const void* wps, const void* alpha,
                                const void* beta, const void* D, const void* A1, const void* iw,
                                const void* ih, void* dg, int BT, int Hp, int Wp, int C,
                                int m2x2, int m3, cudaStream_t stream) {
  if (C % kSlice || C > 128 || m2x2 < 1 || m2x2 > 32 || Wp > 256 || BT > 65535 ||
      iw == nullptr || ih == nullptr || k2a_lite_mma_smem(Wp, m3, C) > 232448)
    return cudaErrorInvalidValue;
  for (const void* p : {ds, g, y, iw, ih, (const void*)dg})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int mth = (2 * m2x2 + 15) / 16;
#define K2AL_MMA(MM, MT)                                                                      \
  if (m3 == MM && mth == MT)                                                                  \
  return launch_k2a_lite_mma_as<MM, MT>(ds, g, y, dsc, two, wps, alpha, beta, D, A1, iw, ih,  \
                                        dg, BT, Hp, Wp, C, m2x2, stream)
  K2AL_MMA(16, 3);   // the cylinder: 2*m2 = 24
  K2AL_MMA(16, 4);   // fsi, combustion: 2*m2 = 32
  K2AL_MMA(16, 1);
  K2AL_MMA(16, 2);
  K2AL_MMA(8, 1);
  K2AL_MMA(8, 2);
  K2AL_MMA(8, 3);
  K2AL_MMA(8, 4);
#undef K2AL_MMA
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2A-lite's tf32 variant
// ---------------------------------------------------------------------------

constexpr int kWpsStrideF = 18;   // f32 row stride of the wps slice (rows 4q apart on 32 banks)

// Bytes of shared memory (ops/kernels.py::k2a_lite_tf32_smem_bytes): the tf32
// DFT body's, then the block's slice of wps [C][16] in f32.
inline int k2a_lite_tf32_smem(int Wp, int m3, int C) {
  return dfttf32::body_smem(Wp, m3) + C * kWpsStrideF * 4;
}

// LiteCorrection's terms in f32, y @ wps as 3xTF32.
template <int M3, int MTH>
struct LiteCorrectionTf32 {
  static constexpr int NTH = 2 * M3 / 8;
  const float* __restrict__ g;
  const float* __restrict__ y;
  const float* __restrict__ dsc;
  const float* __restrict__ two;
  const float* __restrict__ wps;
  const float* __restrict__ alpha;
  const float* __restrict__ beta;
  const float* __restrict__ D;
  const float* __restrict__ A1;
  float* __restrict__ dg;
  int C, m2x2, smem_off;

  // the slice of wps, [C][16] in f32, after the body's shared memory
  __device__ __forceinline__ void stage(unsigned char* p, int tid) const {
    float* sw = reinterpret_cast<float*>(p);
    const int c0 = blockIdx.x * kSlice;
    for (int i = tid; i < C * kSlice; i += blockDim.x) {
      const int cp = i >> 4, c = i & 15;
      sw[cp * kWpsStrideF + c] = wps[(size_t)cp * C + c0 + c];
    }
  }

  __device__ __forceinline__ void operator()(const float (&acc)[MTH][NTH][4], int bt, int c0,
                                             int warp, int lane) const {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const float* sw = reinterpret_cast<const float*>(smem_raw + smem_off);
    const int gq = lane >> 2, q = lane & 3;
    const size_t C2 = 2 * (size_t)C;
    const size_t img = (size_t)bt * m2x2 * M3 * C2;
    const int mbase = (warp * 2 * M3) >> 4;   // the warp's first W mode; it owns NTH / 2
#pragma unroll
    for (int mt = 0; mt < MTH; ++mt) {
      // yw[t] = y @ wps on rows (re|im, j) of this tile, columns (m, c) of tile t
      float yw[NTH][4];
#pragma unroll
      for (int t = 0; t < NTH; ++t) yw[t][0] = yw[t][1] = yw[t][2] = yw[t][3] = 0.f;
      // k runs over 16 channels a step pair, permuted alike in A and B: in
      // step s the lane's k q and q + 4 are channels 4q + 2s and 4q + 2s + 1,
      // so its four values of a row of y for the pair are one 16-byte load
      for (int kp = 0; kp < C / 16; ++kp) {   // y @ wps
        float4 ya[NTH / 2][2];   // rows gq, gq + 8 of this tile at the warp's W modes
#pragma unroll
        for (int mi = 0; mi < NTH / 2; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int R = mt * 16 + gq + hf * 8;
            ya[mi][hf] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (R < 2 * m2x2) {
              const int part = R / m2x2, j = R - part * m2x2;
              ya[mi][hf] = __ldg(reinterpret_cast<const float4*>(
                  y + img + (size_t)(j * M3 + mbase + mi) * C2 + part * C + kp * 16 + 4 * q));
            }
          }
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          // B: wps[kp*16 + 4q + 2st (+1)][c], c = gq (+8)
          const float* wrow = sw + (kp * 16 + 4 * q + 2 * st) * kWpsStrideF + gq;
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              mma::split_tf32(wrow[r * kWpsStrideF + t * 8], bh[t][r], bl[t][r]);
#pragma unroll
          for (int mi = 0; mi < NTH / 2; ++mi) {
            const float4 u = ya[mi][0], w = ya[mi][1];
            const float a[4] = {st ? u.z : u.x, st ? w.z : w.x, st ? u.w : u.y, st ? w.w : w.y};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) mma::split_tf32(a[r], ah[r], al[r]);
#pragma unroll
            for (int t = 0; t < 2; ++t)
              mma::mma_tf32x3(yw[2 * mi + t], ah, al, bh[t][0], bh[t][1], bl[t][0], bl[t][1]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NTH; ++t) {
        const int m = mbase + (t >> 1), cg = c0 + (t & 1) * 8 + 2 * q;
        const float tw0 = two[cg], tw1 = two[cg + 1], dc0 = dsc[cg], dc1 = dsc[cg + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int R = mt * 16 + gq + hf * 8;
          if (R >= 2 * m2x2) continue;
          const int part = R / m2x2, j = R - part * m2x2;
          const int Yr = j * M3 + m, k = Yr * 2 + part;
          const int jm = j == 0 ? 0 : m2x2 - j, Ym = jm * M3 + m;   // kh mirror of j
          const size_t at = img + (size_t)Yr * C2 + part * C + cg;
          const float2 gv = __ldg(reinterpret_cast<const float2*>(g + at));
          float2 gm = make_float2(0.f, 0.f);
          if (Ym != Yr)
            gm = __ldg(reinterpret_cast<const float2*>(g + img + (size_t)Ym * C2 + part * C + cg));
          const float al = alpha[k], be = beta[k], dk = D[k], a1 = A1[k];
          const float o0 = acc[mt][t][2 * hf] + tw0 * (al * gv.x + be * gm.x) +
                           dk * yw[t][2 * hf] + dc0 * a1;
          const float o1 = acc[mt][t][2 * hf + 1] + tw1 * (al * gv.y + be * gm.y) +
                           dk * yw[t][2 * hf + 1] + dc1 * a1;
          *reinterpret_cast<float2*>(dg + at) = make_float2(o0, o1);
        }
      }
    }
  }
};

template <int M3, int MTH>
__global__ void __launch_bounds__(dfttf32::kWarps * 32, 2)
    k2a_lite_tf32_kernel(const float* __restrict__ ds, const float* __restrict__ iw,
                         const float* __restrict__ ih, LiteCorrectionTf32<M3, MTH> epi, int Hp,
                         int Wp, int C) {
  dfttf32::wh_tf32_body<M3, MTH, false>(ds, nullptr, nullptr, iw, ih, epi, Hp, Wp, C,
                                        fno::kActNone);
}

template <int M3, int MTH>
cudaError_t launch_k2a_lite_tf32_as(const void* ds, const void* g, const void* y,
                                    const void* dsc, const void* two, const void* wps,
                                    const void* alpha, const void* beta, const void* D,
                                    const void* A1, const void* iw, const void* ih, void* dg,
                                    int BT, int Hp, int Wp, int C, int m2x2,
                                    cudaStream_t stream) {
  auto kernel = k2a_lite_tf32_kernel<M3, MTH>;
  const int smem = k2a_lite_tf32_smem(Wp, M3, C);
  cudaError_t err = fno::allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const LiteCorrectionTf32<M3, MTH> epi{
      static_cast<const float*>(g),     static_cast<const float*>(y),
      static_cast<const float*>(dsc),   static_cast<const float*>(two),
      static_cast<const float*>(wps),   static_cast<const float*>(alpha),
      static_cast<const float*>(beta),  static_cast<const float*>(D),
      static_cast<const float*>(A1),    static_cast<float*>(dg),
      C, m2x2, dfttf32::body_smem(Wp, M3)};
  // the C/16 slices of one bt are neighbouring blocks: y[bt] and g[bt] come
  // from L2 after the first
  kernel<<<dim3(C / dfttf32::kSlice, BT), dfttf32::kWarps * 32, smem, stream>>>(
      static_cast<const float*>(ds), static_cast<const float*>(iw),
      static_cast<const float*>(ih), epi, Hp, Wp, C);
  return cudaGetLastError();
}

cudaError_t launch_k2a_lite_tf32(const void* ds, const void* g, const void* y, const void* dsc,
                                 const void* two, const void* wps, const void* alpha,
                                 const void* beta, const void* D, const void* A1,
                                 const void* iw, const void* ih, void* dg, int BT, int Hp,
                                 int Wp, int C, int m2x2, int m3, cudaStream_t stream) {
  if (C % dfttf32::kSlice || C > 128 || m2x2 < 1 || m2x2 > 32 || Wp > 256 || BT > 65535 ||
      iw == nullptr || ih == nullptr || k2a_lite_tf32_smem(Wp, m3, C) > 232448)
    return cudaErrorInvalidValue;
  for (const void* p : {ds, g, y, iw, ih, (const void*)dg})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int mth = (2 * m2x2 + 15) / 16;
#define K2AL_TF32(MM, MT)                                                                     \
  if (m3 == MM && mth == MT)                                                                  \
  return launch_k2a_lite_tf32_as<MM, MT>(ds, g, y, dsc, two, wps, alpha, beta, D, A1, iw, ih, \
                                         dg, BT, Hp, Wp, C, m2x2, stream)
  K2AL_TF32(16, 3);   // the cylinder: 2*m2 = 24
  K2AL_TF32(16, 4);   // fsi, combustion: 2*m2 = 32
  K2AL_TF32(16, 1);
  K2AL_TF32(16, 2);
  K2AL_TF32(8, 1);
  K2AL_TF32(8, 2);
  K2AL_TF32(8, 3);
  K2AL_TF32(8, 4);
#undef K2AL_TF32
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of shared memory a block of K2A-lite's mma variant takes.
extern "C" int fno_k2a_lite_mma_smem_bytes(int Wp, int m3, int C) {
  return k2a_lite_mma_smem(Wp, m3, C);
}

// Bytes of shared memory a block of K2A-lite's tf32 variant takes.
extern "C" int fno_k2a_lite_tf32_smem_bytes(int Wp, int m3, int C) {
  return k2a_lite_tf32_smem(Wp, m3, C);
}

// lite = 0: K2A (reads ds, s; g, y, wps and the statics may be null).
// lite = 1: K2A-lite (reads ds, g, y; s may be null).
// variant: 0 fma, 1 mma, 2 tf32 (ops/kernels.py: VARIANTS["k2a_lite"]; mma:
// lite and bf16 only, tf32: lite and f32 only); iw, ih: the DFT tables of the
// mma variant (bf16) or of the tf32 variant (f32), null for fma.
extern "C" int fno_k2a(const void* ds, const void* s, const void* g, const void* y,
                       const void* v1, const void* two, const void* wps, const void* alpha,
                       const void* beta, const void* D, const void* A1, const void* ihr,
                       const void* ihi, const void* iwr, const void* iwi, const void* iw,
                       const void* ih, void* dg, int BT, int Hp, int Wp, int C, int m2x2, int m3,
                       int lite, int variant, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (!lite || dtype != fno::kBF16 || BT < 1 || Hp < 1 || Wp < 1) return cudaErrorInvalidValue;
    return launch_k2a_lite_mma(ds, g, y, v1, two, wps, alpha, beta, D, A1, iw, ih, dg, BT, Hp,
                               Wp, C, m2x2, m3, st);
  }
  if (variant == 2) {
    if (!lite || dtype != fno::kF32 || BT < 1 || Hp < 1 || Wp < 1) return cudaErrorInvalidValue;
    return launch_k2a_lite_tf32(ds, g, y, v1, two, wps, alpha, beta, D, A1, iw, ih, dg, BT, Hp,
                                Wp, C, m2x2, m3, st);
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == fno::kF32)
    return dispatch<float>(lite, ds, s, g, y, v1, two, wps, alpha, beta, D, A1, ihr, ihi, iwr,
                           iwi, dg, BT, Hp, Wp, C, m2x2, m3, st);
  if (dtype == fno::kBF16)
    return dispatch<__nv_bfloat16>(lite, ds, s, g, y, v1, two, wps, alpha, beta, D, A1, ihr,
                                   ihi, iwr, iwi, dg, BT, Hp, Wp, C, m2x2, m3, st);
  return cudaErrorInvalidValue;
}
