// K12B of the fused FNO layer's backward: one pass over the layer input x
// that carries both gradients of z = act(a*x + b) back to x, and the
// gradients of the pointwise conv and of the folded affine:
//   ds_eff = ds + ds1 + 2*ds2*s                  (BN statistics' chain)
//   dz     = F^T(dy) + ds_eff @ Wp^T             (spectral branch: the adjoint of
//                                                 K1's forward (H, W) DFT;
//                                                 pointwise branch)
//   du     = dz * act'(a*x + b),  dx = du * a
//   dWp = z^T ds_eff,  dbp = sum ds_eff,  da = sum du*x,  db = sum du
//
// Replaces realpdebench_tpu/ops/pallas/fno_layer.py::_k12b_kernel.
//
//   x, s, ds [BT, Hp, Wp, C] (T)   dy [BT, 2m2*m3, 2C] (T)
//   a, b, ds1, ds2 [C], wp [C, C] ([in, out])            (f32)
//   ehr, ehi [Hp, 2m2], ewr, ewi [Wp, m3]   K1's forward factors (f32)
//   dx [BT, Hp, Wp, C] (T)
//   partial [BT * kSplit, C*C + 3C] (f32) scratch
//   out [C*C + 3C] (f32): dWp (row c, column d), then da, db, dbp
//
// Design: K2's shape, run on the adjoint factors, with the accumulators
// added. A block takes one bt image and 1/kSplit of its rows; for each row
// h it forms dX[h] = the adjoint H DFT of dy (in shared memory) and stages
// z and ds_eff of the row, then thread (d, column group) produces kWQ
// columns of dz for channel d (each Wp and DFT value read from shared
// memory feeds kWQ FMAs), finishes dx there and sums da, db, dbp for d in
// registers; a second sweep of the staged row adds z^T ds_eff into 16 dWp
// entries per thread. x, s and ds are each read once (x once more for dx
// from L2), dx written once. No atomics: each block writes its partial, and
// fno::reduce_partials adds the partials in a fixed order, so a step is
// deterministic. Bound: ~1.5 MFMA per row of one image (pointwise and dWp
// products 0.55 M each, inverse W 0.27 M), ~170 GFLOP a layer at training
// width, in f32 on CUDA cores with operands from shared memory: the
// shared-memory load rate and FP32 issue bound it, not HBM (~4 GB a layer
// in bf16). Tensor cores for the two [rows, C] x [C, C] products are the
// next step.
#include "fno_common.cuh"

namespace {

constexpr int kThreads = 256;  // C must divide it
constexpr int kWQ = 4;         // dz columns per thread and pass
constexpr int kSplit = 2;      // blocks per bt image (row ranges)
constexpr int kMaxC = 64;      // dWp entries per thread: C*C/kThreads <= 16

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k12b_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, const float* __restrict__ wp,
                const T* __restrict__ s, const T* __restrict__ ds,
                const float* __restrict__ ds1, const float* __restrict__ ds2,
                const T* __restrict__ dy, const float* __restrict__ ehr,
                const float* __restrict__ ehi, const float* __restrict__ ewr,
                const float* __restrict__ ewi, T* __restrict__ dx, float* __restrict__ partial,
                int Hp, int Wp, int C, int m2x2, int m3, int act) {
  extern __shared__ float smem[];
  float* swt = smem;                  // [C][C]: swt[c*C + d] = wp[d*C + c]
  float* sew_r = swt + C * C;         // [m3][Wp]: ewr transposed
  float* sew_i = sew_r + m3 * Wp;
  float* sdx_r = sew_i + m3 * Wp;     // [m3][C]: dX of the current row
  float* sdx_i = sdx_r + m3 * C;
  float* sz = sdx_i + m3 * C;         // [Wp][C]: z of the current row
  float* sd = sz + Wp * C;            // [Wp][C]: ds_eff of the current row
  float* sa = sd + Wp * C;            // [C] each: a, b, ds1, 2*ds2
  float* sb = sa + C;
  float* s1 = sb + C;
  float* s2 = s1 + C;
  float* sred = s2 + C;               // [3][kThreads]

  const int tid = threadIdx.x;
  const int bt = blockIdx.x;
  const int rows = (Hp + kSplit - 1) / kSplit;
  const int h0 = blockIdx.y * rows;
  const int h1 = min(h0 + rows, Hp);
  const int Y = m2x2 * m3;
  for (int i = tid; i < C * C; i += kThreads) {
    const int c = i / C;
    swt[i] = wp[(i - c * C) * C + c];
  }
  for (int i = tid; i < m3 * Wp; i += kThreads) {
    const int m = i / Wp;
    const int w = i - m * Wp;
    sew_r[i] = ewr[w * m3 + m];
    sew_i[i] = ewi[w * m3 + m];
  }
  for (int i = tid; i < C; i += kThreads) {
    sa[i] = a[i];
    sb[i] = b[i];
    s1[i] = ds1[i];
    s2[i] = 2.f * ds2[i];
  }

  const int d = tid % C;
  const int wq = tid / C;
  const int nwq = kThreads / C;
  const int ncg = min(nwq, C);            // channel groups of the dWp sweep
  float da = 0.f, db = 0.f, dbp = 0.f;
  float acc_w[kMaxC * kMaxC / kThreads];  // dWp[wq + ncg*k, d]
#pragma unroll
  for (int k = 0; k < kMaxC * kMaxC / kThreads; ++k) acc_w[k] = 0.f;

  const T* dyb = dy + (size_t)bt * Y * 2 * C;
  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // constants staged; the previous row is consumed
    // dX[h, m, c] = sum_j dyR ehr[h, j] + dyI ehi[h, j]  (re)
    //             = sum_j dyI ehr[h, j] - dyR ehi[h, j]  (im)
    for (int i = tid; i < m3 * C; i += kThreads) {
      const int m = i / C;
      const int c = i - m * C;
      float vr = 0.f, vi = 0.f;
      for (int j = 0; j < m2x2; ++j) {
        const T* p = dyb + (size_t)(j * m3 + m) * 2 * C + c;
        const float yr = fno::to_f32(p[0]);
        const float yi = fno::to_f32(p[C]);
        const float er = ehr[h * m2x2 + j];
        const float ei = ehi[h * m2x2 + j];
        vr = fmaf(yr, er, fmaf(yi, ei, vr));
        vi = fmaf(yi, er, fmaf(-yr, ei, vi));
      }
      sdx_r[i] = vr;
      sdx_i[i] = vi;
    }
    const size_t row = ((size_t)bt * Hp + h) * Wp * C;
    for (int i = tid; i < Wp * C; i += kThreads) {
      const int c = i % C;
      sz[i] = fno::affine_act(fno::to_f32(x[row + i]), sa[c], sb[c], act);
      sd[i] = fno::to_f32(ds[row + i]) + s1[c] + s2[c] * fno::to_f32(s[row + i]);
    }
    __syncthreads();

    // dz for kWQ columns of channel d, then dx and the per-channel sums
    for (int w0 = wq * kWQ; w0 < Wp; w0 += nwq * kWQ) {
      float acc[kWQ];
      int wc[kWQ];
#pragma unroll
      for (int q = 0; q < kWQ; ++q) {
        acc[q] = 0.f;
        wc[q] = min(w0 + q, Wp - 1);  // the ragged edge computes a duplicate, never stored
      }
      for (int m = 0; m < m3; ++m) {
        const float vr = sdx_r[m * C + d];
        const float vi = sdx_i[m * C + d];
#pragma unroll
        for (int q = 0; q < kWQ; ++q)
          acc[q] = fmaf(vr, sew_r[m * Wp + wc[q]], fmaf(vi, sew_i[m * Wp + wc[q]], acc[q]));
      }
      for (int c = 0; c < C; ++c) {
        const float wv = swt[c * C + d];
#pragma unroll
        for (int q = 0; q < kWQ; ++q) acc[q] = fmaf(sd[wc[q] * C + c], wv, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kWQ; ++q) {
        if (w0 + q < Wp) {
          const size_t at = row + (size_t)(w0 + q) * C + d;
          const float xv = fno::to_f32(x[at]);
          const float du = acc[q] * fno::act_grad(fmaf(sa[d], xv, sb[d]), act);
          dx[at] = fno::from_f32<T>(du * sa[d]);
          da = fmaf(du, xv, da);
          db += du;
          dbp += sd[(w0 + q) * C + d];
        }
      }
    }

    // dWp[c, d] += sum over the row of z[w, c] * ds_eff[w, d]
    if (wq < ncg) {
      for (int w = 0; w < Wp; ++w) {
        const float dv = sd[w * C + d];
#pragma unroll
        for (int k = 0; k < kMaxC * kMaxC / kThreads; ++k) {
          const int c = wq + ncg * k;
          if (c < C) acc_w[k] = fmaf(sz[w * C + c], dv, acc_w[k]);
        }
      }
    }
  }

  const int n = C * C + 3 * C;
  float* pb = partial + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * n;
  if (wq < ncg) {
#pragma unroll
    for (int k = 0; k < kMaxC * kMaxC / kThreads; ++k) {
      const int c = wq + ncg * k;
      if (c < C) pb[c * C + d] = acc_w[k];
    }
  }
  sred[tid] = da;
  sred[kThreads + tid] = db;
  sred[2 * kThreads + tid] = dbp;
  __syncthreads();
  if (tid < C) {
    float v[3] = {0.f, 0.f, 0.f};
    for (int q = 0; q < nwq; ++q)
      for (int r = 0; r < 3; ++r) v[r] += sred[r * kThreads + q * C + tid];
    for (int r = 0; r < 3; ++r) pb[C * C + r * C + tid] = v[r];
  }
}

template <typename T>
cudaError_t launch_k12b(const void* x, const void* a, const void* b, const void* wp,
                        const void* s, const void* ds, const void* ds1, const void* ds2,
                        const void* dy, const void* ehr, const void* ehi, const void* ewr,
                        const void* ewi, void* dx, void* partial, void* out, int BT, int Hp,
                        int Wp, int C, int m2x2, int m3, int act, cudaStream_t stream) {
  if (C < 1 || C > kMaxC || kThreads % C != 0 || m2x2 < 1 || m3 < 1 || BT < 1 || Hp < 1 ||
      Wp < 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)C * C + 2 * (size_t)m3 * Wp + 2 * (size_t)m3 * C +
                       2 * (size_t)Wp * C + 4 * (size_t)C + 3 * (size_t)kThreads);
  cudaError_t err = fno::allow_smem(k12b_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BT, kSplit);
  k12b_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(wp), static_cast<const T*>(s), static_cast<const T*>(ds),
      static_cast<const float*>(ds1), static_cast<const float*>(ds2),
      static_cast<const T*>(dy), static_cast<const float*>(ehr),
      static_cast<const float*>(ehi), static_cast<const float*>(ewr),
      static_cast<const float*>(ewi), static_cast<T*>(dx), static_cast<float*>(partial), Hp,
      Wp, C, m2x2, m3, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(out),
                              BT * kSplit, C * C + 3 * C, stream);
}

}  // namespace

// Number of [C*C + 3C] partials the caller allocates as K12B's scratch.
extern "C" int fno_k12b_num_partials(int BT) { return BT * kSplit; }

extern "C" int fno_k12b(const void* x, const void* a, const void* b, const void* wp,
                        const void* s, const void* ds, const void* ds1, const void* ds2,
                        const void* dy, const void* ehr, const void* ehi, const void* ewr,
                        const void* ewi, void* dx, void* partial, void* out, int BT, int Hp,
                        int Wp, int C, int m2x2, int m3, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == fno::kF32)
    return launch_k12b<float>(x, a, b, wp, s, ds, ds1, ds2, dy, ehr, ehi, ewr, ewi, dx, partial,
                              out, BT, Hp, Wp, C, m2x2, m3, act, st);
  if (dtype == fno::kBF16)
    return launch_k12b<__nv_bfloat16>(x, a, b, wp, s, ds, ds1, ds2, dy, ehr, ehi, ewr, ewi, dx,
                                      partial, out, BT, Hp, Wp, C, m2x2, m3, act, st);
  return cudaErrorInvalidValue;
}
