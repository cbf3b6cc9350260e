// K3F and K3B: the FNO3d's tail and training loss, forward and backward.
//   z  = crop(s)                      (t < T, h < H, w < W of the padded grid)
//   u1 = z @ k1 + b1,  h1 = act(u1)   (fc1, the last BatchNorm folded into k1, b1)
//   o  = h1 @ k2 + b2                 (fc2)
//   SSE = sum (o - target)^2
// K3B recomputes the forward and, with g = dL/dSSE, writes
//   do = 2 g (o - target),  du = (do @ k2^T) * act'(u1),  ds = du @ k1^T
// (zero outside the crop) and the accumulators dk1 = z^T du, db1 = sum du,
// dk2 = h1^T do, db2 = sum do.
//
// Replaces realpdebench_tpu/ops/pallas/fno_tail.py::_k3f_kernel and
// ::_k3b_kernel.
//
//   s [B*Tp, Hp, Wp, C] (T)        target [B, T, H, W, F] (f32)
//   k1 [C, H1], b1 [H1], k2 [H1, F], b2 [F] (f32), H1 = 128, F <= kMaxF
//   K3F: partial [B*T] (f32) scratch, sse [1] (f32)
//   K3B: g [1] (f32, device), ds like s (T),
//        partial [B*Tp, C*H1 + H1 + H1*F + F] (f32) scratch,
//        out [C*H1 + H1 + H1*F + F] (f32): dk1, db1, dk2, db2
//
// Design: one block per (b, t) image walks its H*W cropped positions in
// tiles of kP. Per tile it stages z (and the target) in shared memory; each
// thread holds a 4 x 8 (hidden unit x position) register tile of u1, so a
// k1 value and a z value read from shared memory feed 8 and 4 FMAs; h1 and
// then du share one [kP, H1] buffer. fc2 (F <= 8 outputs) is a short loop.
// K3B keeps u1 in registers from the forward to du, and holds its dk1
// share (32 entries a thread up to C 64, 64 up to C 128) in registers
// across the tiles. The fc1
// activation and the prediction never reach device memory. No atomics: each
// block writes its partial sums, and fno::reduce_partials adds them in a
// fixed order. Bound: fc1 and its two backward products are ~8.4 kFMA per
// position each (~90 GFLOP for K3F, ~260 for K3B at 32 x 20 x 64 x 128
// positions), in f32 on CUDA cores from shared memory: FP32 issue bounds
// it, not HBM (~0.7 GB read); tensor cores are the next step.
#include "fno_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kP = 64;       // positions per tile
constexpr int kH1 = 128;     // fc1 width
constexpr int kH1P = 132;    // padded row stride of the [kP, H1] buffer (bank spread)
constexpr int kMaxF = 8;     // fc2 width bound
constexpr int kMaxC = 128;   // channel bound (C % 8 == 0)

struct TailDims {
  int T, H, W, Tp, Hp, Wp, C, F, act;
};

// Stage the tile's z = crop(s) [kP][C] and target [kP][F]; rows past the
// image's H*W positions are zero.
template <typename T>
__device__ void stage_tile(const T* __restrict__ s, const float* __restrict__ target, int bt,
                           int bT, int p0, int npos, const TailDims& d, float* sz, float* sy) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kP * d.C; i += kThreads) {
    const int p = i / d.C;
    const int c = i - p * d.C;
    float v = 0.f;
    if (p0 + p < npos) {
      const int h = (p0 + p) / d.W;
      const int w = (p0 + p) - h * d.W;
      v = fno::to_f32(s[(((size_t)bt * d.Hp + h) * d.Wp + w) * d.C + c]);
    }
    sz[i] = v;
  }
  for (int i = tid; i < kP * d.F; i += kThreads) {
    const int p = i / d.F;
    sy[i] = p0 + p < npos ? target[((size_t)bT * npos + p0) * d.F + i] : 0.f;
  }
}

// u[jk][pk] = (z @ k1 + b1)[p, j] for j = jq + 32 jk, p = pq + 8 pk.
__device__ __forceinline__ void fc1_tile(const float* sz, const float* sk1, const float* sb1,
                                         int C, int jq, int pq, float (&u)[4][8]) {
#pragma unroll
  for (int jk = 0; jk < 4; ++jk)
#pragma unroll
    for (int pk = 0; pk < 8; ++pk) u[jk][pk] = sb1[jq + 32 * jk];
  for (int c = 0; c < C; ++c) {
    float kv[4], zv[8];
#pragma unroll
    for (int jk = 0; jk < 4; ++jk) kv[jk] = sk1[c * (kH1 + 1) + jq + 32 * jk];
#pragma unroll
    for (int pk = 0; pk < 8; ++pk) zv[pk] = sz[(pq + 8 * pk) * C + c];
#pragma unroll
    for (int jk = 0; jk < 4; ++jk)
#pragma unroll
      for (int pk = 0; pk < 8; ++pk) u[jk][pk] = fmaf(zv[pk], kv[jk], u[jk][pk]);
  }
}

// Shared-memory layout of both kernels (floats).
struct Smem {
  float *sk1, *sb1, *sk2, *sb2, *sz, *sy, *sh, *sdo, *sred;
  __device__ Smem(float* base, int C, int F) {
    sk1 = base;                       // [C][kH1 + 1]
    sb1 = sk1 + C * (kH1 + 1);        // [kH1]
    sk2 = sb1 + kH1;                  // [kH1][F]
    sb2 = sk2 + kH1 * F;              // [F]
    sz = sb2 + kMaxF;                 // [kP][C]
    sy = sz + kP * C;                 // [kP][F]
    sh = sy + kP * kMaxF;             // [kP][kH1P]: h1, then du
    sdo = sh + kP * kH1P;             // [kP][F]
    sred = sdo + kP * kMaxF;          // [kThreads]
  }
};

size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)C * (kH1 + 1) + kH1 + kH1 * kMaxF + kMaxF + kP * C +
                          kP * kMaxF + kP * kH1P + kP * kMaxF + kThreads);
}

__device__ void load_weights(const Smem& sm, const float* k1, const float* b1, const float* k2,
                             const float* b2, int C, int F) {
  for (int i = threadIdx.x; i < C * kH1; i += kThreads) {
    const int c = i / kH1;
    sm.sk1[c * (kH1 + 1) + (i - c * kH1)] = k1[i];
  }
  for (int i = threadIdx.x; i < kH1; i += kThreads) sm.sb1[i] = b1[i];
  for (int i = threadIdx.x; i < kH1 * F; i += kThreads) sm.sk2[i] = k2[i];
  for (int i = threadIdx.x; i < F; i += kThreads) sm.sb2[i] = b2[i];
}

// Sum of v over the block's threads, in a fixed order; valid in thread 0.
__device__ float block_sum(float v, float* sred) {
  sred[threadIdx.x] = v;
  __syncthreads();
  float acc = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads; ++i) acc += sred[i];
  __syncthreads();
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k3f_kernel(const T* __restrict__ s, const float* __restrict__ target,
               const float* __restrict__ k1, const float* __restrict__ b1,
               const float* __restrict__ k2, const float* __restrict__ b2,
               float* __restrict__ partial, TailDims d) {
  extern __shared__ float smem[];
  const Smem sm(smem, d.C, d.F);
  load_weights(sm, k1, b1, k2, b2, d.C, d.F);
  const int bT = blockIdx.x;                          // b*T + t
  const int bt = (bT / d.T) * d.Tp + bT % d.T;        // its row of s
  const int npos = d.H * d.W;
  const int jq = threadIdx.x % 32, pq = threadIdx.x / 32;
  float sse = 0.f;
  for (int p0 = 0; p0 < npos; p0 += kP) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(s, target, bt, bT, p0, npos, d, sm.sz, sm.sy);
    __syncthreads();
    float u[4][8];
    fc1_tile(sm.sz, sm.sk1, sm.sb1, d.C, jq, pq, u);
#pragma unroll
    for (int jk = 0; jk < 4; ++jk)
#pragma unroll
      for (int pk = 0; pk < 8; ++pk)
        sm.sh[(pq + 8 * pk) * kH1P + jq + 32 * jk] = fno::act_fn(u[jk][pk], d.act);
    __syncthreads();
    for (int i = threadIdx.x; i < kP * d.F; i += kThreads) {
      const int p = i / d.F;
      const int f = i - p * d.F;
      if (p0 + p < npos) {
        float o = sm.sb2[f];
        for (int j = 0; j < kH1; ++j) o = fmaf(sm.sh[p * kH1P + j], sm.sk2[j * d.F + f], o);
        const float diff = o - sm.sy[i];
        sse = fmaf(diff, diff, sse);
      }
    }
  }
  __syncthreads();
  const float tot = block_sum(sse, sm.sred);
  if (threadIdx.x == 0) partial[bT] = tot;
}

// CK: the dk1 rows a thread holds, cq + 8 ck for ck < CK (C <= 8 CK). Up
// to C 64 two blocks share an SM (at most 128 registers a thread); left to
// itself ptxas takes 177, one block an SM, and the kernel runs 1.4x longer.
template <typename T, int CK>
__global__ void __launch_bounds__(kThreads, CK <= 8 ? 2 : 1)
    k3b_kernel(const T* __restrict__ s, const float* __restrict__ target,
               const float* __restrict__ k1, const float* __restrict__ b1,
               const float* __restrict__ k2, const float* __restrict__ b2,
               const float* __restrict__ g, T* __restrict__ ds, float* __restrict__ partial,
               TailDims d) {
  extern __shared__ float smem[];
  const Smem sm(smem, d.C, d.F);
  const int tid = threadIdx.x;
  const int bt = blockIdx.x;                          // row of s: b*Tp + t
  const int t = bt % d.Tp;
  const int bT = (bt / d.Tp) * d.T + t;
  const int C = d.C, F = d.F;
  const int npos = d.H * d.W;
  const int n = C * kH1 + kH1 + kH1 * F + F;
  float* pb = partial + (size_t)bt * n;
  T* dsb = ds + (size_t)bt * d.Hp * d.Wp * C;
  if (t >= d.T) {  // end padding in T: ds is zero and adds nothing
    for (size_t i = tid; i < (size_t)d.Hp * d.Wp * C; i += kThreads) dsb[i] = fno::from_f32<T>(0.f);
    for (int i = tid; i < n; i += kThreads) pb[i] = 0.f;
    return;
  }
  load_weights(sm, k1, b1, k2, b2, C, F);
  const float g2 = 2.f * g[0];
  const int jq = tid % 32, pq = tid / 32;
  float dk1[CK][4];                                   // dk1[cq + 8 ck, jq + 32 jk]
#pragma unroll
  for (int ck = 0; ck < CK; ++ck)
#pragma unroll
    for (int jk = 0; jk < 4; ++jk) dk1[ck][jk] = 0.f;
  float dk2[kMaxF * kH1 / kThreads];                  // dk2 entries tid + 256 k
#pragma unroll
  for (int k = 0; k < kMaxF * kH1 / kThreads; ++k) dk2[k] = 0.f;
  float db1 = 0.f, db2 = 0.f;                         // db1[tid < H1], db2[tid < F]

  for (int p0 = 0; p0 < npos; p0 += kP) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(s, target, bt, bT, p0, npos, d, sm.sz, sm.sy);
    __syncthreads();
    float u[4][8];
    fc1_tile(sm.sz, sm.sk1, sm.sb1, C, jq, pq, u);
#pragma unroll
    for (int jk = 0; jk < 4; ++jk)
#pragma unroll
      for (int pk = 0; pk < 8; ++pk)
        sm.sh[(pq + 8 * pk) * kH1P + jq + 32 * jk] = fno::act_fn(u[jk][pk], d.act);
    __syncthreads();
    // do = 2 g (o - target), zero past the image's positions
    for (int i = tid; i < kP * F; i += kThreads) {
      const int p = i / F;
      const int f = i - p * F;
      float v = 0.f;
      if (p0 + p < npos) {
        float o = sm.sb2[f];
        for (int j = 0; j < kH1; ++j) o = fmaf(sm.sh[p * kH1P + j], sm.sk2[j * F + f], o);
        v = g2 * (o - sm.sy[i]);
      }
      sm.sdo[i] = v;
    }
    __syncthreads();
    // dk2 += h1^T do, db2 += sum do (before du overwrites h1)
#pragma unroll
    for (int k = 0; k < kMaxF * kH1 / kThreads; ++k) {
      const int e = tid + kThreads * k;
      if (e < kH1 * F) {
        const int j = e / F;
        const int f = e - j * F;
        for (int p = 0; p < kP; ++p) dk2[k] = fmaf(sm.sh[p * kH1P + j], sm.sdo[p * F + f], dk2[k]);
      }
    }
    if (tid < F)
      for (int p = 0; p < kP; ++p) db2 += sm.sdo[p * F + tid];
    __syncthreads();
    // du = (do @ k2^T) * act'(u1) over the register tile
#pragma unroll
    for (int jk = 0; jk < 4; ++jk) {
      const int j = jq + 32 * jk;
#pragma unroll
      for (int pk = 0; pk < 8; ++pk) {
        const int p = pq + 8 * pk;
        float dh = 0.f;
        for (int f = 0; f < F; ++f) dh = fmaf(sm.sdo[p * F + f], sm.sk2[j * F + f], dh);
        sm.sh[p * kH1P + j] = dh * fno::act_grad(u[jk][pk], d.act);
      }
    }
    __syncthreads();
    if (tid < kH1)
      for (int p = 0; p < kP; ++p) db1 += sm.sh[p * kH1P + tid];
    // ds = du @ k1^T on the cropped positions: thread (4 channels, 4 positions)
    const int ncq = C / 4;
    for (int task = tid; task < ncq * (kP / 4); task += kThreads) {
      const int c0 = 4 * (task % ncq);
      const int pg = 4 * (task / ncq);
      float acc[4][4] = {};
      for (int j = 0; j < kH1; ++j) {
        float kv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sm.sk1[(c0 + i) * (kH1 + 1) + j];
          dv[i] = sm.sh[(pg + i) * kH1P + j];
        }
#pragma unroll
        for (int pi = 0; pi < 4; ++pi)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) acc[pi][ci] = fmaf(dv[pi], kv[ci], acc[pi][ci]);
      }
#pragma unroll
      for (int pi = 0; pi < 4; ++pi) {
        const int pp = p0 + pg + pi;
        if (pp < npos) {
          const int h = pp / d.W;
          const int w = pp - h * d.W;
          T* dst = dsb + ((size_t)h * d.Wp + w) * C + c0;
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) dst[ci] = fno::from_f32<T>(acc[pi][ci]);
        }
      }
    }
    // dk1 += z^T du: thread (channels cq + 8 ck, hidden units jq + 32 jk)
    const int cq = tid / 32;
    for (int p = 0; p < kP; ++p) {
      float dv[4];
#pragma unroll
      for (int jk = 0; jk < 4; ++jk) dv[jk] = sm.sh[p * kH1P + jq + 32 * jk];
#pragma unroll
      for (int ck = 0; ck < CK; ++ck) {
        if (cq + 8 * ck < C) {
          const float zv = sm.sz[p * C + cq + 8 * ck];
#pragma unroll
          for (int jk = 0; jk < 4; ++jk) dk1[ck][jk] = fmaf(zv, dv[jk], dk1[ck][jk]);
        }
      }
    }
  }
  // zeros outside the crop (h >= H or w >= W) of this image
  for (size_t i = tid; i < (size_t)d.Hp * d.Wp * C; i += kThreads) {
    const int pos = (int)(i / C);
    const int h = pos / d.Wp;
    if (h >= d.H || pos - h * d.Wp >= d.W) dsb[i] = fno::from_f32<T>(0.f);
  }
  const int cq = tid / 32;
#pragma unroll
  for (int ck = 0; ck < CK; ++ck)
    if (cq + 8 * ck < C)
#pragma unroll
      for (int jk = 0; jk < 4; ++jk) pb[(cq + 8 * ck) * kH1 + jq + 32 * jk] = dk1[ck][jk];
  if (tid < kH1) pb[C * kH1 + tid] = db1;
#pragma unroll
  for (int k = 0; k < kMaxF * kH1 / kThreads; ++k) {
    const int e = tid + kThreads * k;
    if (e < kH1 * F) pb[C * kH1 + kH1 + e] = dk2[k];
  }
  if (tid < F) pb[C * kH1 + kH1 + kH1 * F + tid] = db2;
}

cudaError_t check_dims(const TailDims& d, int B, int H1) {
  if (B < 1 || d.T < 1 || d.H < 1 || d.W < 1 || d.T > d.Tp || d.H > d.Hp || d.W > d.Wp ||
      d.C < 8 || d.C > kMaxC || d.C % 8 != 0 || d.F < 1 || d.F > kMaxF || H1 != kH1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_k3f(const void* s, const void* target, const void* k1, const void* b1,
                       const void* k2, const void* b2, void* partial, void* sse, int B,
                       const TailDims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d.C);
  cudaError_t err = fno::allow_smem(k3f_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  k3f_kernel<T><<<B * d.T, kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const float*>(target),
      static_cast<const float*>(k1), static_cast<const float*>(b1),
      static_cast<const float*>(k2), static_cast<const float*>(b2),
      static_cast<float*>(partial), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(sse),
                              B * d.T, 1, stream);
}

template <typename T, int CK>
cudaError_t launch_k3b_as(const void* s, const void* target, const void* k1, const void* b1,
                          const void* k2, const void* b2, const void* g, void* ds, void* partial,
                          int B, const TailDims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d.C);
  cudaError_t err = fno::allow_smem(k3b_kernel<T, CK>, smem);
  if (err != cudaSuccess) return err;
  k3b_kernel<T, CK><<<B * d.Tp, kThreads, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const float*>(target),
      static_cast<const float*>(k1), static_cast<const float*>(b1),
      static_cast<const float*>(k2), static_cast<const float*>(b2),
      static_cast<const float*>(g), static_cast<T*>(ds), static_cast<float*>(partial), d);
  return cudaGetLastError();
}

// dk1 in registers: 32 entries a thread up to C 64, 64 above.
template <typename T>
cudaError_t launch_k3b(const void* s, const void* target, const void* k1, const void* b1,
                       const void* k2, const void* b2, const void* g, void* ds, void* partial,
                       void* out, int B, const TailDims& d, cudaStream_t stream) {
  cudaError_t err =
      d.C <= 64 ? launch_k3b_as<T, 8>(s, target, k1, b1, k2, b2, g, ds, partial, B, d, stream)
                : launch_k3b_as<T, 16>(s, target, k1, b1, k2, b2, g, ds, partial, B, d, stream);
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(out),
                              B * d.Tp, d.C * kH1 + kH1 + kH1 * d.F + d.F, stream);
}

}  // namespace

extern "C" int fno_k3f(const void* s, const void* target, const void* k1, const void* b1,
                       const void* k2, const void* b2, void* partial, void* sse, int B, int T,
                       int H, int W, int Tp, int Hp, int Wp, int C, int H1, int F, int act,
                       int dtype, void* stream) {
  const TailDims d{T, H, W, Tp, Hp, Wp, C, F, act};
  cudaError_t err = check_dims(d, B, H1);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == fno::kF32) return launch_k3f<float>(s, target, k1, b1, k2, b2, partial, sse, B, d, st);
  if (dtype == fno::kBF16)
    return launch_k3f<__nv_bfloat16>(s, target, k1, b1, k2, b2, partial, sse, B, d, st);
  return cudaErrorInvalidValue;
}

extern "C" int fno_k3b(const void* s, const void* target, const void* k1, const void* b1,
                       const void* k2, const void* b2, const void* g, void* ds, void* partial,
                       void* out, int B, int T, int H, int W, int Tp, int Hp, int Wp, int C,
                       int H1, int F, int act, int dtype, void* stream) {
  const TailDims d{T, H, W, Tp, Hp, Wp, C, F, act};
  cudaError_t err = check_dims(d, B, H1);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == fno::kF32)
    return launch_k3b<float>(s, target, k1, b1, k2, b2, g, ds, partial, out, B, d, st);
  if (dtype == fno::kBF16)
    return launch_k3b<__nv_bfloat16>(s, target, k1, b1, k2, b2, g, ds, partial, out, B, d, st);
  return cudaErrorInvalidValue;
}
