// K2 of the fused FNO layer: inverse H DFT (2*m2 modes -> Hp rows), inverse
// W DFT with Hermitian doubling to Wp real columns, plus the 1x1 pointwise
// conv of the recomputed z = act(a*x + b) and its bias: the pre-BN output
//   s = irfft2(g) + z @ Wp + bp,
// and the per-channel BatchNorm statistics (sum, sum of squares) of s over
// every padded position.
//
// Replaces realpdebench_tpu/ops/pallas/fno_layer.py::_k2_kernel.
//
//   g  [BT, 2m2*m3, 2C] (T)     mode spectra, rows (j2, m), lanes (re | im, c)
//   x  [BT, Hp, Wp, C]  (T)     the layer input (z is recomputed from it)
//   a, b [C], bp [C]    (f32);  wp [C, C] (f32, [in, out])
//   ihr, ihi [2m2, Hp]  (f32)   inverse H DFT (1/Hp included)
//   iwr, iwi [m3, Wp]   (f32)   irfft rows with the Hermitian weights
//   s  [BT, Hp, Wp, C]  (T)
//   partial [BT * ceil(Hp/kHT), 2, C] (f32) scratch; stats [2, C] (f32)
//
// Design: one block per (bt, kHT rows of H). The block first inverts H for
// its rows into shared memory (ih [kHT, m3, C] complex), then for each row
// stages z[h] and lets thread (d, column group) produce kWQ output columns
// of channel d at once, so each Wp[c, d] read from shared memory feeds kWQ
// FMAs. Blocks run in no order, so the statistics take two passes: each
// block writes its own (sum, sumsq) partial in a fixed order, and
// fno::reduce_partials adds the partials in a fixed order in f64. The result is
// deterministic; against a tree-ordered f32 sum it differs at f32 rounding
// of the partials (relative ~1e-6 of sum |s|).
// Bound: at rollout width one layer reads ~270 MB, writes ~250 MB and does
// ~27 GFLOP, three fifths of it the pointwise [rows, C] x [C, C] product; on
// CUDA cores with operands from shared memory the shared-memory load rate
// bounds it. Tensor cores (wgmma for the pointwise and the inverse-W
// contraction) are the next step.
#include "fno_common.cuh"

namespace {

constexpr int kHT = 5;         // H rows per block
constexpr int kThreads = 256;  // threads per block; C must divide it
constexpr int kWQ = 4;         // output columns per thread and pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k2_kernel(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ wp,
              const float* __restrict__ bp, const float* __restrict__ ihr,
              const float* __restrict__ ihi, const float* __restrict__ iwr,
              const float* __restrict__ iwi, T* __restrict__ s, float* __restrict__ partial,
              int Hp, int Wp, int C, int m2x2, int m3, int act) {
  extern __shared__ float smem[];
  float* swp = smem;                  // [C][C]
  float* siw_r = swp + C * C;         // [m3][Wp]
  float* siw_i = siw_r + m3 * Wp;
  float* sih_r = siw_i + m3 * Wp;     // [kHT][m3][C]
  float* sih_i = sih_r + kHT * m3 * C;
  float* sz = sih_i + kHT * m3 * C;   // [Wp][C]
  float* sa = sz + Wp * C;            // [C]
  float* sb = sa + C;
  float* sbp = sb + C;
  float* sred = sbp + C;              // [2][kThreads]

  const int tid = threadIdx.x;
  const int bt = blockIdx.x;
  const int h0 = blockIdx.y * kHT;
  const int Y = m2x2 * m3;
  for (int i = tid; i < C * C; i += kThreads) swp[i] = wp[i];
  for (int i = tid; i < m3 * Wp; i += kThreads) {
    siw_r[i] = iwr[i];
    siw_i[i] = iwi[i];
  }
  for (int i = tid; i < C; i += kThreads) {
    sa[i] = a[i];
    sb[i] = b[i];
    sbp[i] = bp[i];
  }

  // inverse H for the block's rows: ih[hl, m, c] = sum_j g[j, m, c] * Ih[j, h0 + hl]
  const T* gb = g + (size_t)bt * Y * 2 * C;
  for (int i = tid; i < kHT * m3 * C; i += kThreads) {
    const int hl = i / (m3 * C);
    const int rem = i - hl * m3 * C;
    const int m = rem / C;
    const int c = rem - m * C;
    const int h = h0 + hl;
    float vr = 0.f, vi = 0.f;
    if (h < Hp) {
      for (int j = 0; j < m2x2; ++j) {
        const T* gp = gb + (size_t)(j * m3 + m) * 2 * C + c;
        const float gr = fno::to_f32(gp[0]);
        const float gi = fno::to_f32(gp[C]);
        const float er = ihr[j * Hp + h];
        const float ei = ihi[j * Hp + h];
        vr = fmaf(gr, er, fmaf(-gi, ei, vr));
        vi = fmaf(gr, ei, fmaf(gi, er, vi));
      }
    }
    sih_r[i] = vr;
    sih_i[i] = vi;
  }

  const int d = tid % C;
  const int wq = tid / C;
  const int nwq = kThreads / C;
  float ssum = 0.f, ssq = 0.f;
  const int hend = min(h0 + kHT, Hp);
  for (int h = h0; h < hend; ++h) {
    __syncthreads();  // constants and ih staged; the previous z row is consumed
    const T* xh = x + ((size_t)bt * Hp + h) * Wp * C;
    for (int i = tid; i < Wp * C; i += kThreads) {
      const int c = i % C;
      sz[i] = fno::affine_act(fno::to_f32(xh[i]), sa[c], sb[c], act);
    }
    __syncthreads();
    const float* ihr_h = sih_r + (h - h0) * m3 * C;
    const float* ihi_h = sih_i + (h - h0) * m3 * C;
    T* sh = s + ((size_t)bt * Hp + h) * Wp * C;
    for (int w0 = wq * kWQ; w0 < Wp; w0 += nwq * kWQ) {
      float acc[kWQ];
      int wc[kWQ];
#pragma unroll
      for (int q = 0; q < kWQ; ++q) {
        acc[q] = sbp[d];
        wc[q] = min(w0 + q, Wp - 1);  // the ragged edge computes a duplicate, never stored
      }
      for (int m = 0; m < m3; ++m) {
        const float vr = ihr_h[m * C + d];
        const float vi = ihi_h[m * C + d];
#pragma unroll
        for (int q = 0; q < kWQ; ++q)
          acc[q] = fmaf(vr, siw_r[m * Wp + wc[q]], fmaf(vi, siw_i[m * Wp + wc[q]], acc[q]));
      }
      for (int c = 0; c < C; ++c) {
        const float wv = swp[c * C + d];
#pragma unroll
        for (int q = 0; q < kWQ; ++q) acc[q] = fmaf(sz[wc[q] * C + c], wv, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kWQ; ++q) {
        if (w0 + q < Wp) {
          sh[(size_t)(w0 + q) * C + d] = fno::from_f32<T>(acc[q]);
          ssum += acc[q];
          ssq = fmaf(acc[q], acc[q], ssq);
        }
      }
    }
  }

  sred[tid] = ssum;
  sred[kThreads + tid] = ssq;
  __syncthreads();
  if (tid < C) {
    float ps = 0.f, pq = 0.f;
    for (int q = 0; q < nwq; ++q) {
      ps += sred[q * C + tid];
      pq += sred[kThreads + q * C + tid];
    }
    float* pb = partial + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * 2 * C;
    pb[tid] = ps;
    pb[C + tid] = pq;
  }
}

int num_hblocks(int Hp) { return (Hp + kHT - 1) / kHT; }

template <typename T>
cudaError_t launch_k2(const void* g, const void* x, const void* a, const void* b,
                      const void* wp, const void* bp, const void* ihr, const void* ihi,
                      const void* iwr, const void* iwi, void* s, void* partial, void* stats,
                      int BT, int Hp, int Wp, int C, int m2x2, int m3, int act,
                      cudaStream_t stream) {
  if (C < 1 || C > kThreads || kThreads % C != 0 || m2x2 < 1 || m3 < 1 || BT < 1 || Hp < 1 ||
      Wp < 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)C * C + 2 * (size_t)m3 * Wp + 2 * (size_t)kHT * m3 * C +
                       (size_t)Wp * C + 3 * (size_t)C + 2 * (size_t)kThreads);
  cudaError_t err = fno::allow_smem(k2_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BT, num_hblocks(Hp));
  k2_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(wp),
      static_cast<const float*>(bp), static_cast<const float*>(ihr),
      static_cast<const float*>(ihi), static_cast<const float*>(iwr),
      static_cast<const float*>(iwi), static_cast<T*>(s), static_cast<float*>(partial), Hp,
      Wp, C, m2x2, m3, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(stats),
                              BT * num_hblocks(Hp), 2 * C, stream);
}

}  // namespace

// Number of [2, C] partials the caller allocates as K2's scratch.
extern "C" int fno_k2_num_partials(int BT, int Hp) { return BT * num_hblocks(Hp); }

extern "C" int fno_k2(const void* g, const void* x, const void* a, const void* b,
                      const void* wp, const void* bp, const void* ihr, const void* ihi,
                      const void* iwr, const void* iwi, void* s, void* partial, void* stats,
                      int BT, int Hp, int Wp, int C, int m2x2, int m3, int act, int dtype,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == fno::kF32)
    return launch_k2<float>(g, x, a, b, wp, bp, ihr, ihi, iwr, iwi, s, partial, stats, BT, Hp,
                            Wp, C, m2x2, m3, act, st);
  if (dtype == fno::kBF16)
    return launch_k2<__nv_bfloat16>(g, x, a, b, wp, bp, ihr, ihi, iwr, iwi, s, partial, stats,
                                    BT, Hp, Wp, C, m2x2, m3, act, st);
  return cudaErrorInvalidValue;
}
