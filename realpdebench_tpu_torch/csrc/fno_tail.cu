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
//   k1 [C, H1], b1 [H1], k2 [H1, F], b2 [F] (f32), H1 = 128, F <= kMaxF (16)
//   K3F: partial [fno_k3f_num_partials] (f32) scratch, sse [1] (f32)
//   K3B: g [1] (f32, device), ds like s (T),
//        partial [fno_k3b_num_partials, C*H1 + H1 + H1*F + F] (f32) scratch,
//        out [C*H1 + H1 + H1*F + F] (f32): dk1, db1, dk2, db2
//
// Each kernel has three variants, chosen before the launch by
// ops/kernels.py::k3f_variant and ::k3b_variant. The fc1 activation and the
// prediction never reach device memory in any. No atomics: each block
// writes its partial sums, and fno::reduce_partials adds them in a fixed
// order, so two identical calls are bit-equal.
//
// `fma` (widths other than 32, 64, 128, misaligned s): one
// block per (b, t) image walks its H*W cropped positions in tiles of kP. Per
// tile it stages z (and the target) in shared memory; each thread holds a
// 4 x 8 (hidden unit x position) register tile of u1, so a k1 value and a z
// value read from shared memory feed 8 and 4 FMAs; h1 and then du share one
// [kP, H1] buffer. fc2 (F <= 16 outputs) is a short loop. K3B keeps u1 in
// registers from the forward to du, and holds its dk1 share (32 entries a
// thread up to C 64, 64 up to C 128) in registers across the tiles. Exact
// f32 FMAs on the CUDA cores from shared memory: FP32 issue bounds it (fc1
// and its two backward products are 16 kFLOP a position each at C 64), not
// HBM.
//
// `mma` (bf16 s; C in {32, 64, 128}, F <= 16, 16-byte aligned s): a
// persistent grid walks 128-position tiles of the crop (40960 at training
// width), z filled by 16-byte cp.async into a two-stage ring. Both kernels
// run one forward (forward_warp below): fc1 on mma.sync with k1 as a bf16
// hi + lo pair (z is bf16 already), the activation a template argument, fc2
// from u1's fragments with h1 and k2 as hi + lo pairs. K3F adds (o -
// target)^2 per thread in f64, one partial a block; it holds no more than
// k1, two z stages and k2 (75 KB at C 64), two blocks an SM. K3B (one block
// an SM, 255 registers) adds do, du, ds and the five products' sums: every
// operand of the f32 sums (dk1, db1, dk2, db2, held to 1e-4 of the sum of
// |terms|) that is not bf16 already is a hi + lo pair; ds rounds once on its
// write, and its product takes du and k1 rounded once. Bound at training
// width (32 x 20 x 64 x 128 positions, C 64): K3F 0.73 GB of HBM (0.22 ms)
// and 90 GFLOP of products (0.09 ms at the bf16 peak; fc1's hi + lo make
// ~0.17 TFLOP of MMAs issued); K3B 1.73 GB (0.52 ms) and 270 GFLOP (~700
// issued).
//
// `tf32` (f32 s; the mma variant's widths, F and alignment): the mma
// variant's plan (persistent grids over the same tiles, the two-stage
// cp.async ring over z, one shared forward with the activation a template
// argument, K3B's sums flushed every few tiles) with every product 3xTF32
// on mma.sync m16n8k8 (each f32 operand split in registers into a tf32
// hi + lo pair by mma.cuh's split_tf32, hi.hi + hi.lo + lo.hi, f32
// accumulators). What f32 changes: z is f32 and split too;
// ds is a 3xTF32 product as well (one rounding of du and k1 would leave
// 5e-4 of max|ds|); there is no
// ldmatrix.trans for tf32, so each operand is stored once, in f32, in a
// layout whose 32- or 64-bit fragment loads fall on 32 banks (z by ldmatrix
// as fc1's A; k1 [C][kTfKS] read both ways, as fc1's B and as ds's), and
// the k order of a k-step is permuted alike in A and B wherever an operand
// comes from accumulators (slot q holds index 2q, slot q + 4 index 2q + 1).
// Shared memory doubles: at C 64 a K3F block takes 107 KB (two an SM) and a
// K3B block 181 KB (one); at C 128 K3B keeps one z stage (213 KB), its next
// tile's copy issued after the tile's last read of z. Bound at training
// width in f32: K3F 1.40 GB (0.42 ms), K3B 3.40 GB (1.02 ms), the products
// at the TF32 peak below that.
//
// fc2's width F: the tensor-core variants pad it to NF = 8 (F <= 8: one
// n-tile of eight columns, the layout and arithmetic of the first
// versions) or NF = 16 (9 <= F <= 16, the combustion scenario's 16
// channels: two n-tiles, so each fc2 product, do, dk2 and db2 twice). The
// columns past F are zero in k2^T, b2 and do, and stay out of the SSE and
// the sums. NF is a template argument: the F <= 8 kernels are the ones they
// were. NF 16 is built for the combustion scenario's (C 64, exact) alone
// (with_mma_instance).
#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "fno_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kP = 64;       // positions per tile
constexpr int kH1 = 128;     // fc1 width
constexpr int kH1P = 132;    // padded row stride of the [kP, H1] buffer (bank spread)
constexpr int kMaxF = 16;    // fc2 width bound
constexpr int kMaxC = 128;   // channel bound (C % 8 == 0)

struct TailDims {
  int T, H, W, Tp, Hp, Wp, C, F, act, B;
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

// ---------------------------------------------------------------------------
// The tensor-core variants of K3F and K3B (bf16; C in {32, 64, 128}, fc1
// width 128, F <= 16 padded to NF): one forward, shared
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTP = 128;           // positions a tile takes: up to 128 of one cropped row
constexpr int kMmaThreads = 256;   // 8 warps, warp w owning positions 16w..16w+15 of a tile
constexpr int kKS = kH1 + 8;       // row stride of the [.][128] tiles (bank spread)
constexpr int kDoS = 24;           // row stride of the do tile [kTP][16]
// tiles a partial row sums: a block writes its sums and restarts them every
// kFlush of its tiles, so no f32 accumulator (an MMA's, which truncates)
// takes more than kFlush * 8 products of 16 positions
constexpr int kFlush = 32;
// the same for K3B's tf32 variant, whose accumulators take 16 k-steps of
// three MMAs a tile. At 32 tiles their drift toward zero reached dk1 and db1
// (1.2e-5 of the sum of |terms|) and, through the last BatchNorm's
// statistics folded into k1 and b1, the f32 step's gradient of the last
// layer's low-mode spectral weights: 9.1e-5 from the plain step's (relative
// L2; with K3B's fma variant 9.2e-6); at 8 tiles 1.1e-5, at 4 below 5.7e-6
// with twice the rows of partial sums (tools/torch_tail_grad_ab.py, H100)
constexpr int kFlushTf32 = 8;
__host__ __device__ constexpr int flush_tiles(int variant) {
  return variant == 2 ? kFlushTf32 : kFlush;
}

// fc2's width padded to whole n-tiles of 8 columns: 8 for F <= 8, else 16.
__host__ __device__ constexpr int fc2_width(int F) { return F <= 8 ? 8 : 16; }

// Shared memory of a K3B block, in bytes (ops/kernels.py::k3b_mma_smem_bytes):
// k1 hi, lo [C][kKS]; two z stages [kTP][C + 8]; h1 (then du) hi, lo
// [kTP][kKS]; do hi, lo [kTP][kDoS] (bf16); k2^T hi, lo [NF][kKS] (bf16);
// k2 [kH1][NF], b1, b2, the warps' db2 [8][NF] (f32).
inline int k3b_mma_smem(int C, int NF) {
  return 2 * (2 * C * kKS + 2 * kTP * (C + 8) + 2 * kTP * kKS +
              2 * kTP * kDoS + 2 * NF * kKS) +
         4 * (kH1 * NF + kH1 + NF + 8 * NF);
}

// Shared memory of a K3F block, in bytes (ops/kernels.py::k3f_mma_smem_bytes):
// k1 hi, lo [C][kKS]; two z stages [kTP][C + 8]; k2^T hi, lo [NF][kKS]
// (bf16); b1, b2 (f32); the warps' sums [8] (f64). None of K3B's h1, du
// and do tiles: about 75 KB at C 64 (79 KB at NF 16).
inline int k3f_mma_smem(int C, int NF) {
  return 2 * (2 * C * kKS + 2 * kTP * (C + 8) + 2 * NF * kKS) + 4 * (kH1 + NF) + 8 * 8;
}

// The weights in a block's shared memory: k1 [C][kH1] as hi, lo [2][C][kKS];
// k2^T as hi, lo [2][NF][kKS] (rows >= F zero); b1 [kH1], b2 [NF] (zero past
// F); and, where sk2f is given (K3B), k2 [kH1][NF] in f32.
template <int C, int NF>
__device__ void load_mma_weights(const float* __restrict__ k1, const float* __restrict__ b1,
                                 const float* __restrict__ k2, const float* __restrict__ b2,
                                 int F, bf16* sk1, bf16* sk2t, float* sk2f, float* sb1,
                                 float* sb2) {
  const int tid = threadIdx.x;
  for (int i = tid; i < C * kH1; i += kMmaThreads) {
    const int c = i / kH1, j = i - c * kH1;
    mma::split_bf16(k1[i], sk1[c * kKS + j], sk1[C * kKS + c * kKS + j]);
  }
  for (int i = tid; i < NF * kH1; i += kMmaThreads) {
    const int f = i / kH1, j = i - f * kH1;
    const float v = f < F ? k2[j * F + f] : 0.f;
    mma::split_bf16(v, sk2t[f * kKS + j], sk2t[NF * kKS + f * kKS + j]);
    if (sk2f) sk2f[j * NF + f] = v;
  }
  for (int i = tid; i < kH1; i += kMmaThreads) sb1[i] = b1[i];
  if (tid < NF) sb2[tid] = tid < F ? b2[tid] : 0.f;
}

// The crop as tiles of up to kTP positions of one cropped row, in the order
// (image bT, row h, tile of the row), which a persistent grid walks.
struct CropTiles {
  int nwt, ntiles;
  __device__ explicit CropTiles(const TailDims& d)
      : nwt((d.W + kTP - 1) / kTP), ntiles(d.B * d.T * d.H * nwt) {}
  // tile -> (row bT of the target, cropped row h, first position w0, row bt of s)
  __device__ void decode(const TailDims& d, int tile, int& bT, int& h, int& w0, int& bt) const {
    const int wt = tile % nwt, rest = tile / nwt;
    h = rest % d.H;
    bT = rest / d.H;
    w0 = wt * kTP;
    bt = (bT / d.T) * d.Tp + bT % d.T;
  }
  // z of `tile` into dst [kTP][ZS] (bf16: C + 8; f32: C + 4) by 16-byte
  // cp.async, one committed group; rows past the tile's positions zero
  template <int C, typename T = bf16, int ZS = C + 8>
  __device__ void fetch(const T* __restrict__ s, const TailDims& d, int tile, T* dst) const {
    constexpr int V = 16 / sizeof(T);   // elements a copy moves
    int bT, h, w0, bt;
    decode(d, tile, bT, h, w0, bt);
    const int P = min(kTP, d.W - w0);
    const T* src = s + (((size_t)bt * d.Hp + h) * d.Wp + w0) * C;
    for (int i = threadIdx.x; i < kTP * (C / V); i += kMmaThreads) {
      const int p = i / (C / V), cc = i - p * (C / V);
      if (p < P)
        mma::cp_async_16(dst + p * ZS + cc * V, src + (size_t)p * C + cc * V);
      else
        *reinterpret_cast<uint4*>(dst + p * ZS + cc * V) = make_uint4(0, 0, 0, 0);
    }
    mma::cp_async_commit();
  }
};

// The forward of one warp on its 16 positions p0.. of the tile zt:
//   u1 = z k1 + b1            mma, k1 hi + lo (z is bf16)
//   h1 = act(u1)              one erf (and, for K3B, one exp) a position and unit
//   o = h1 k2                 mma, h1 and k2 hi + lo, from the u1 fragments,
//                             NF / 8 n-tiles of k2^T [NF][kKS]
// o[n][e] is (o without b2)[p0 + gq + 8 (e >> 1)][8 n + 2q + (e & 1)], lane =
// 4 gq + q. With GRAD (K3B), h1's hi and lo go to sh [2][kTP][kKS] and u
// keeps act'(u1) in u1's fragment layout; without (K3F), h1 stays in
// registers.
template <int C, int ACT, bool GRAD, int NF>
__device__ __forceinline__ void forward_warp(const bf16* zt, const bf16* sk1, const bf16* sk2t,
                                             const float* sb1, int p0, int lane,
                                             float (&u)[16][4], float (&o)[NF / 8][4],
                                             bf16* sh) {
  constexpr int ZS = C + 8;
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 bv = *reinterpret_cast<const float2*>(sb1 + nt * 8 + 2 * q);
    u[nt][0] = u[nt][2] = bv.x;
    u[nt][1] = u[nt][3] = bv.y;
  }
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t fa[4];
    mma::ldmatrix_x4(fa, mma::smem_addr(zt + p0 * ZS + mma::a_frag_offset(lane, ks * 16, ZS)));
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      int k, n;
      mma::b_frag_row(lane, ks * 16, np * 16, k, n);
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        uint32_t fb[4];
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(sk1 + hl * C * kKS + k * kKS + n));
        mma::mma_bf16(u[2 * np], fa, fb[0], fb[1]);
        mma::mma_bf16(u[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NF / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int nt = 2 * ks + (r >> 1), hf = r & 1;
      float hv0, hv1;
      if constexpr (GRAD) {
        fno::act_and_grad_fast(u[nt][2 * hf], ACT, hv0, u[nt][2 * hf]);
        fno::act_and_grad_fast(u[nt][2 * hf + 1], ACT, hv1, u[nt][2 * hf + 1]);
      } else {
        hv0 = fno::affine_act_fast(u[nt][2 * hf], 1.f, 0.f, ACT);
        hv1 = fno::affine_act_fast(u[nt][2 * hf + 1], 1.f, 0.f, ACT);
      }
      mma::split_pack(hv0, hv1, ahi[r], alo[r]);
      if constexpr (GRAD) {
        const int at = (p0 + gq + hf * 8) * kKS + nt * 8 + 2 * q;
        *reinterpret_cast<uint32_t*>(sh + at) = ahi[r];
        *reinterpret_cast<uint32_t*>(sh + kTP * kKS + at) = alo[r];
      }
    }
#pragma unroll
    for (int n = 0; n < NF / 8; ++n) {
      const int kb = (8 * n + gq) * kKS + ks * 16 + 2 * q;
      const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(sk2t + kb);
      const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(sk2t + kb + 8);
      const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(sk2t + NF * kKS + kb);
      const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(sk2t + NF * kKS + kb + 8);
      mma::mma_bf16(o[n], ahi, bh0, bh1);
      mma::mma_bf16(o[n], alo, bh0, bh1);
      mma::mma_bf16(o[n], ahi, bl0, bl1);
    }
  }
}

// A K3F tensor-core block's partial: its threads' f64 sums added in a
// fixed order (shuffles, then the warps in turn through sred [8]).
__device__ __forceinline__ void write_block_sse(double sse, double* sred, float* partial) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) sse += __shfl_xor_sync(0xffffffffu, sse, m);
  if (lane == 0) sred[warp] = sse;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < kMmaThreads / 32; ++w) tot += sred[w];
    partial[blockIdx.x] = (float)tot;
  }
}

// K3F's tensor-core variant. A persistent grid (as many blocks as fit the
// SMs, never more than tiles) walks the crop's tiles t = blockIdx.x + i *
// gridDim.x; z comes by 16-byte cp.async into a two-stage ring (the next
// tile's copy overlaps this one); each warp runs forward_warp on its 16
// positions and adds (o + b2 - target)^2 of its valid (position, f) into
// a per-thread f64 sum. The block adds its threads' sums in a fixed order
// (shuffles, then the warps in turn) into its partial; fno::reduce_partials
// adds the partials in a fixed order: no atomics. It holds none of K3B's
// sums and tiles: ~75 KB of shared memory and no more than 128 registers,
// two blocks an SM at C <= 64.
template <int C, int ACT, int NF>
__global__ void __launch_bounds__(kMmaThreads, 2)
    k3f_mma_kernel(const bf16* __restrict__ s, const float* __restrict__ target,
                   const float* __restrict__ k1, const float* __restrict__ b1,
                   const float* __restrict__ k2, const float* __restrict__ b2,
                   float* __restrict__ partial, TailDims d) {
  constexpr int ZS = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk1 = reinterpret_cast<bf16*>(smem_raw);   // [2][C][kKS]: k1 hi, lo
  bf16* sz = sk1 + 2 * C * kKS;                    // [2 stages][kTP][ZS]
  bf16* sk2t = sz + 2 * kTP * ZS;                  // [2][NF][kKS]: k2^T hi, lo
  float* sb1 = reinterpret_cast<float*>(sk2t + 2 * NF * kKS);
  float* sb2 = sb1 + kH1;                          // [NF]
  double* sred = reinterpret_cast<double*>(sb2 + NF);   // [8 warps]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  load_mma_weights<C, NF>(k1, b1, k2, b2, d.F, sk1, sk2t, nullptr, sb1, sb2);
  const CropTiles ct(d);
  const int p0 = warp * 16;
  double sse = 0.0;
  int tile = blockIdx.x, it = 0;
  if (tile < ct.ntiles) ct.fetch<C>(s, d, tile, sz);
  for (; tile < ct.ntiles; ++it, tile += gridDim.x) {
    const int stage = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();   // z of this tile has landed; the previous tile's readers are done
    if (tile + gridDim.x < ct.ntiles) ct.fetch<C>(s, d, tile + gridDim.x, sz + (stage ^ 1) * kTP * ZS);
    int bT, h, w0, bt;
    ct.decode(d, tile, bT, h, w0, bt);
    const int P = min(kTP, d.W - w0);
    float u[16][4], o[NF / 8][4];
    forward_warp<C, ACT, false, NF>(sz + stage * kTP * ZS, sk1, sk2t, sb1, p0, lane, u, o,
                                    nullptr);
#pragma unroll
    for (int n = 0; n < NF / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gq + (e >> 1) * 8, f = 8 * n + 2 * q + (e & 1);
        if (p < P && f < d.F) {
          const float diff =
              o[n][e] + sb2[f] - target[(((size_t)bT * d.H + h) * d.W + w0 + p) * d.F + f];
          sse += (double)(diff * diff);
        }
      }
  }
  write_block_sse(sse, sred, partial);
}

// du = (do k2^T) act'(u1) in place of act'(u1) in u (forward_warp's
// layout); dv: this lane's do in o's layout, sk2f: k2 [kH1][NF] in f32
// (columns >= F zero). Exact f32 FMAs, F a unit.
template <int NF>
__device__ __forceinline__ void tail_du(const float (&dv)[NF / 8][4], const float* sk2f, int F,
                                        int gq, int q, float (&u)[16][4]) {
  float dor[2][NF];   // do of this lane's rows gq, gq + 8
#pragma unroll
  for (int n = 0; n < NF / 8; ++n)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dor[e >> 1][8 * n + 2 * qq + (e & 1)] = __shfl_sync(0xffffffffu, dv[n][e], gq * 4 + qq);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float* kr = sk2f + (nt * 8 + 2 * q + jj) * NF;
      float kv[NF];
#pragma unroll
      for (int v4 = 0; v4 < NF / 4; ++v4) {
        const float4 ka = *reinterpret_cast<const float4*>(kr + 4 * v4);
        kv[4 * v4] = ka.x;
        kv[4 * v4 + 1] = ka.y;
        kv[4 * v4 + 2] = ka.z;
        kv[4 * v4 + 3] = ka.w;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float dh = 0.f;
#pragma unroll
        for (int f = 0; f < NF; ++f)
          if (f < F) dh = fmaf(dor[rr][f], kv[f], dh);
        u[nt][2 * rr + jj] *= dh;
      }
    }
}

// Row pb of a K3B tensor-core block's partial sums, in the layout of
// k3b_kernel's (dk1, db1, dk2, db2), from its warps' accumulators: dk1
// [C/16 + 1][2][4] (channels 16 mi + gq (+8), hidden units 16 warp + 8 nt +
// 2q (+1); db1 in mi = C/16, row gq 0), dk2 [NF/8][4] (units 16 warp + gq
// (+8), columns 8n + 2q (+1)), db2 [NF/8][2] (columns 8n + 2q (+1) over this
// lane's positions: added over the warp, then over the warps in order
// through sred [8][NF]). The sums restart from zero.
template <int C, int NF>
__device__ __forceinline__ void flush_k3b_sums(float* pb, int F, float (&dk1)[C / 16 + 1][2][4],
                                               float (&dk2)[NF / 8][4], float (&db2)[NF / 8][2],
                                               float* sred, int warp, int lane) {
  constexpr int MC = C / 16;
  const int tid = threadIdx.x, gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MC; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = mi * 16 + gq + hf * 8, j = 16 * warp + nt * 8 + 2 * q;
        pb[c * kH1 + j] = dk1[mi][nt][2 * hf];
        pb[c * kH1 + j + 1] = dk1[mi][nt][2 * hf + 1];
      }
  if (gq == 0)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = 16 * warp + nt * 8 + 2 * q;
      pb[C * kH1 + j] = dk1[MC][nt][0];
      pb[C * kH1 + j + 1] = dk1[MC][nt][1];
    }
#pragma unroll
  for (int n = 0; n < NF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 16 * warp + gq + (e >> 1) * 8, f = 8 * n + 2 * q + (e & 1);
      if (f < F) pb[C * kH1 + kH1 + j * F + f] = dk2[n][e];
    }
#pragma unroll
  for (int n = 0; n < NF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = db2[n][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gq == 0) sred[warp * NF + 8 * n + 2 * q + e] = v;
    }
  __syncthreads();
  if (tid < F) {
    float v = 0.f;
    for (int w = 0; w < kMmaThreads / 32; ++w) v += sred[w * NF + tid];
    pb[C * kH1 + kH1 + kH1 * F + tid] = v;
  }
  __syncthreads();   // sred is read before the next flush writes it
#pragma unroll
  for (int mi = 0; mi <= MC; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      dk1[mi][nt][0] = dk1[mi][nt][1] = dk1[mi][nt][2] = dk1[mi][nt][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NF / 8; ++n) {
    dk2[n][0] = dk2[n][1] = dk2[n][2] = dk2[n][3] = 0.f;
    db2[n][0] = db2[n][1] = 0.f;
  }
}

// Zeros of ds outside the crop, a share of the rows a block (16-byte
// stores): rows of images t >= T and rows h >= H whole, positions w >= W of
// the cropped rows.
template <int C, typename T>
__device__ void zero_outside_crop(T* __restrict__ ds, const TailDims& d) {
  constexpr int V = 16 / sizeof(T);   // elements a store writes
  const int rows = d.B * d.Tp * d.Hp;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int bt = r / d.Hp, h = r - bt * d.Hp;
    const int w_from = (bt % d.Tp < d.T && h < d.H) ? d.W : 0;
    uint4* dst = reinterpret_cast<uint4*>(ds + ((size_t)r * d.Wp + w_from) * C);
    for (int i = threadIdx.x; i < (d.Wp - w_from) * (C / V); i += kMmaThreads)
      dst[i] = make_uint4(0, 0, 0, 0);
  }
}

// K3B's tensor-core variant. One persistent block an SM walks the crop's
// tiles t = blockIdx.x + i * gridDim.x; per tile, each warp on its 16
// positions runs forward_warp (h1 hi, lo into shared memory, u keeping
// act'(u1)), then
//   do = 2 g (o + b2 - target) f32; db2 in registers
//   du = (do k2^T) act'(u1)   F FMAs a unit, f32
//   ds = du k1^T              mma, du and k1 rounded once; written once as bf16
// and, after the tile's h1, do and du are in shared memory, the block's
// sums: dk2 += h1^T do (mma, every operand hi + lo) with warp w on hidden
// units 16w..16w+15, and dk1 += z^T du with a row of ones under z^T that
// gives db1 = sum du (mma, du hi + lo) on the same units. dk1, db1, dk2 and
// db2 stay in registers across kFlush of the block's tiles, then go out as
// one of the block's rows of partial sums, which fno::reduce_partials adds
// in a fixed order: no atomics. The activation is a template argument: a
// runtime switch inlined the tanh and erff forms beside the exact one at
// every unit and cost 3.8 ms in spills and issue (tools/torch_k3b_probe.py).
// Zeros outside the crop are written after the tiles, a share of the rows a
// block.
template <int C, int ACT, int NF>
__global__ void __launch_bounds__(kMmaThreads, 1)
    k3b_mma_kernel(const bf16* __restrict__ s, const float* __restrict__ target,
                   const float* __restrict__ k1, const float* __restrict__ b1,
                   const float* __restrict__ k2, const float* __restrict__ b2,
                   const float* __restrict__ gsc, bf16* __restrict__ ds,
                   float* __restrict__ partial, TailDims d) {
  constexpr int ZS = C + 8;            // z row stride
  constexpr int MC = C / 16;           // 16-row tiles of z^T; tile MC is the row of ones
  constexpr int NG = 32;               // channels of ds a pass takes
  constexpr int NT = NF / 8;           // fc2's n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk1 = reinterpret_cast<bf16*>(smem_raw);   // [2][C][kKS]: k1 hi, lo
  bf16* sz = sk1 + 2 * C * kKS;                    // [2 stages][kTP][ZS]
  bf16* sh = sz + 2 * kTP * ZS;                    // [2][kTP][kKS]: h1, then du, hi and lo
  bf16* sdo = sh + 2 * kTP * kKS;                  // [2][kTP][kDoS]: do hi, lo (columns >= NF zero)
  bf16* sk2t = sdo + 2 * kTP * kDoS;               // [2][NF][kKS]: k2^T hi, lo (rows >= F zero)
  float* sk2f = reinterpret_cast<float*>(sk2t + 2 * NF * kKS);   // [kH1][NF]: k2 (columns >= F zero)
  float* sb1 = sk2f + kH1 * NF;
  float* sb2 = sb1 + kH1;                          // [NF]
  float* sred = sb2 + NF;                          // [8 warps][NF]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int F = d.F, W = d.W, H = d.H;
  load_mma_weights<C, NF>(k1, b1, k2, b2, F, sk1, sk2t, sk2f, sb1, sb2);
  for (int i = tid; i < 2 * kTP * (kDoS - NF) / 8; i += kMmaThreads) {
    const int r = i / ((kDoS - NF) / 8), cc = i - r * ((kDoS - NF) / 8);
    *reinterpret_cast<uint4*>(sdo + r * kDoS + NF + cc * 8) = make_uint4(0, 0, 0, 0);
  }
  const float g2 = 2.f * gsc[0];
  const CropTiles ct(d);
  const int ntiles = ct.ntiles;
  // rows of partial sums a block writes: one per kFlush tiles of the most a block takes
  const int nrows = ((ntiles + gridDim.x - 1) / gridDim.x + kFlush - 1) / kFlush;
  const int n = C * kH1 + kH1 + kH1 * F + F;

  float dk1[MC + 1][2][4];   // dk1[c][16 warp + 8 nt + 2q (+1)] for c = 16 mi + gq (+8); db1 in mi = MC
  float dk2[NT][4];          // dk2[16 warp + gq (+8)][8n + 2q (+1)]
  float db2[NT][2];          // db2[8n + 2q (+1)], this lane's positions
#pragma unroll
  for (int mi = 0; mi <= MC; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) dk1[mi][nt][0] = dk1[mi][nt][1] = dk1[mi][nt][2] = dk1[mi][nt][3] = 0.f;
#pragma unroll
  for (int nf = 0; nf < NT; ++nf) {
    dk2[nf][0] = dk2[nf][1] = dk2[nf][2] = dk2[nf][3] = 0.f;
    db2[nf][0] = db2[nf][1] = 0.f;
  }

  // row r of this block's partial sums; the sums restart from zero
  auto flush = [&](int r) {
    flush_k3b_sums<C, NF>(partial + ((size_t)blockIdx.x * nrows + r) * n, F, dk1, dk2, db2,
                          sred, warp, lane);
  };

  int tile = blockIdx.x, it = 0;
  if (tile < ntiles) ct.fetch<C>(s, d, tile, sz);
  const int p0 = warp * 16;
  for (; tile < ntiles; ++it, tile += gridDim.x) {
    const int stage = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();   // z of this tile has landed; the previous tile's readers are done
    if (tile + gridDim.x < ntiles) ct.fetch<C>(s, d, tile + gridDim.x, sz + (stage ^ 1) * kTP * ZS);
    int bT, h, w0, bt;
    ct.decode(d, tile, bT, h, w0, bt);
    const int P = min(kTP, W - w0);
    const bf16* zt = sz + stage * kTP * ZS;

    // u1, h1 (into shared memory, hi and lo) and o on this warp's 16
    // positions; u keeps act'(u1)
    float u[16][4], o[NT][4];
    forward_warp<C, ACT, true, NF>(zt, sk1, sk2t, sb1, p0, lane, u, o, sh);

    // do = 2 g (o + b2 - target), zero past the tile's positions and F
    float dv[NT][4];
#pragma unroll
    for (int nf = 0; nf < NT; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gq + (e >> 1) * 8, f = 8 * nf + 2 * q + (e & 1);
        dv[nf][e] = 0.f;
        if (p < P && f < F)
          dv[nf][e] =
              g2 * (o[nf][e] + sb2[f] - target[(((size_t)bT * H + h) * W + w0 + p) * F + f]);
      }
      db2[nf][0] += dv[nf][0] + dv[nf][2];
      db2[nf][1] += dv[nf][1] + dv[nf][3];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t hi, lo;
        mma::split_pack(dv[nf][2 * hf], dv[nf][2 * hf + 1], hi, lo);
        const int at = (p0 + gq + hf * 8) * kDoS + 8 * nf + 2 * q;
        *reinterpret_cast<uint32_t*>(sdo + at) = hi;
        *reinterpret_cast<uint32_t*>(sdo + kTP * kDoS + at) = lo;
      }
    }

    // du = (do k2^T) act'(u1), in place of act'(u1)
    tail_du<NF>(dv, sk2f, F, gq, q, u);

    // ds = du k1^T, this warp's positions, NG channels a pass
    bf16* dsb = ds + (((size_t)bt * d.Hp + h) * d.Wp + w0) * C;
#pragma unroll
    for (int cg = 0; cg < C / NG; ++cg) {
      float acc[NG / 8][4];
#pragma unroll
      for (int nt = 0; nt < NG / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t fa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int nt = 2 * ks + (r >> 1), hf = r & 1;
          fa[r] = mma::pack_bf16(u[nt][2 * hf], u[nt][2 * hf + 1]);
        }
#pragma unroll
        for (int np = 0; np < NG / 16; ++np) {
          int n, k;
          mma::bt_frag_row(lane, ks * 16, cg * NG + np * 16, n, k);
          uint32_t fb[4];
          mma::ldmatrix_x4(fb, mma::smem_addr(sk1 + n * kKS + k));
          mma::mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
          mma::mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NG / 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = p0 + gq + hf * 8;
          if (p < P)
            *reinterpret_cast<uint32_t*>(dsb + (size_t)p * C + cg * NG + nt * 8 + 2 * q) =
                mma::pack_bf16(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
        }
    }
    __syncthreads();   // every warp's h1 and do are in shared memory

    // dk2 += h1^T do on hidden units 16 warp .. + 15
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      int k, m;
      mma::at_frag_row(lane, ks * 16, 16 * warp, k, m);
      uint32_t ah[4], al[4], bh[4], bl[4];
      mma::ldmatrix_x4_trans(ah, mma::smem_addr(sh + k * kKS + m));
      mma::ldmatrix_x4_trans(al, mma::smem_addr(sh + kTP * kKS + k * kKS + m));
      int kk, n;
      mma::b_frag_row(lane, ks * 16, 0, kk, n);
      mma::ldmatrix_x4_trans(bh, mma::smem_addr(sdo + kk * kDoS + n));
      mma::ldmatrix_x4_trans(bl, mma::smem_addr(sdo + kTP * kDoS + kk * kDoS + n));
      mma::mma_bf16(dk2[0], ah, bh[0], bh[1]);
      mma::mma_bf16(dk2[0], al, bh[0], bh[1]);
      mma::mma_bf16(dk2[0], ah, bl[0], bl[1]);
      if constexpr (NT == 2) {   // columns 8..15: the x4 load's second pair
        mma::mma_bf16(dk2[1], ah, bh[2], bh[3]);
        mma::mma_bf16(dk2[1], al, bh[2], bh[3]);
        mma::mma_bf16(dk2[1], ah, bl[2], bl[3]);
      }
    }
    __syncthreads();   // h1 is read: du takes its place
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t hi, lo;
        mma::split_pack(u[nt][2 * hf], u[nt][2 * hf + 1], hi, lo);
        const int at = (p0 + gq + hf * 8) * kKS + nt * 8 + 2 * q;
        *reinterpret_cast<uint32_t*>(sh + at) = hi;
        *reinterpret_cast<uint32_t*>(sh + kTP * kKS + at) = lo;
      }
    __syncthreads();   // every warp's du is in shared memory

    // dk1 += z^T du and db1 += 1^T du on hidden units 16 warp .. + 15
    const uint32_t one = gq == 0 ? 0x3F803F80u : 0u;   // row 0 of the ones tile: bf16 1.0, 1.0
    const uint32_t ones[4] = {one, 0u, one, 0u};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      int k, n;
      mma::b_frag_row(lane, ks * 16, 16 * warp, k, n);
      uint32_t bh[4], bl[4];
      mma::ldmatrix_x4_trans(bh, mma::smem_addr(sh + k * kKS + n));
      mma::ldmatrix_x4_trans(bl, mma::smem_addr(sh + kTP * kKS + k * kKS + n));
#pragma unroll
      for (int mi = 0; mi <= MC; ++mi) {
        uint32_t fa[4];
        if (mi < MC) {
          int kz, mz;
          mma::at_frag_row(lane, ks * 16, mi * 16, kz, mz);
          mma::ldmatrix_x4_trans(fa, mma::smem_addr(zt + kz * ZS + mz));
        } else {
          fa[0] = ones[0];
          fa[1] = ones[1];
          fa[2] = ones[2];
          fa[3] = ones[3];
        }
        mma::mma_bf16(dk1[mi][0], fa, bh[0], bh[1]);
        mma::mma_bf16(dk1[mi][0], fa, bl[0], bl[1]);
        mma::mma_bf16(dk1[mi][1], fa, bh[2], bh[3]);
        mma::mma_bf16(dk1[mi][1], fa, bl[2], bl[3]);
      }
    }
    if ((it + 1) % kFlush == 0) flush(it / kFlush);
  }
  // the last rows: the sums of a group under kFlush tiles, then zeros
  for (int r = it / kFlush; r < nrows; ++r) flush(r);
  zero_outside_crop<C>(ds, d);
}

// ---------------------------------------------------------------------------
// The tf32 variants of K3F and K3B (f32; C in {32, 64, 128}, fc1 width 128,
// F <= 16 padded to NF): the tensor-core variants' plan, every product 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTfKS = kH1 + 8;   // row stride of k1 [C][.] and k2^T [NF][.] (f32: 8 mod 32)
constexpr int kTfHS = kH1 + 4;   // row stride of the h1 / du tile [kTP][.] (f32: 4 mod 32)
constexpr int kTfDS = kTP + 8;   // row stride of do^T [NF][.] (f32: 8 mod 32)

// z stages of a K3B tf32 block: two up to C 64, one at C 128, where two
// would not fit beside k1 and the h1 / du tile.
__host__ __device__ constexpr int k3b_tf32_stages(int C) { return C <= 64 ? 2 : 1; }

// Shared memory of a K3F tf32 block, in bytes (ops/kernels.py::
// k3f_tf32_smem_bytes), all f32: two z stages [kTP][C + 4]; k1 [C][kTfKS];
// k2^T [NF][kTfKS]; b1, b2; the warps' sums [8] (f64). 107 KB at C 64 (111
// KB at NF 16): two blocks an SM.
inline int k3f_tf32_smem(int C, int NF) {
  return 4 * (2 * kTP * (C + 4) + C * kTfKS + NF * kTfKS + kH1 + NF) + 8 * 8;
}

// Shared memory of a K3B tf32 block, in bytes (ops/kernels.py::
// k3b_tf32_smem_bytes), all f32: k3b_tf32_stages(C) z stages [kTP][C + 4];
// k1 [C][kTfKS]; h1, then du [kTP][kTfHS]; do^T [NF][kTfDS]; k2^T
// [NF][kTfKS]; k2 [kH1][NF]; b1, b2, the warps' db2 [8][NF]. 181 KB at C 64,
// 213 KB at C 128 (194 and 226 KB at NF 16): one block an SM.
inline int k3b_tf32_smem(int C, int NF) {
  return 4 * (k3b_tf32_stages(C) * kTP * (C + 4) + C * kTfKS + kTP * kTfHS + NF * kTfDS +
              NF * kTfKS + kH1 * NF + kH1 + NF + 8 * NF);
}

// The weights in f32 in a tf32 block's shared memory: k1 [C][kTfKS]; k2^T
// [NF][kTfKS] (rows >= F zero); b1 [kH1], b2 [NF] (zero past F); and, where
// sk2f is given (K3B), k2 [kH1][NF].
template <int C, int NF>
__device__ void load_tf32_weights(const float* __restrict__ k1, const float* __restrict__ b1,
                                  const float* __restrict__ k2, const float* __restrict__ b2,
                                  int F, float* sk1, float* sk2t, float* sk2f, float* sb1,
                                  float* sb2) {
  const int tid = threadIdx.x;
  for (int i = tid; i < C * kH1; i += kMmaThreads) {
    const int c = i / kH1;
    sk1[c * kTfKS + i - c * kH1] = k1[i];
  }
  for (int i = tid; i < NF * kH1; i += kMmaThreads) {
    const int f = i / kH1, j = i - f * kH1;
    const float v = f < F ? k2[j * F + f] : 0.f;
    sk2t[f * kTfKS + j] = v;
    if (sk2f) sk2f[j * NF + f] = v;
  }
  for (int i = tid; i < kH1; i += kMmaThreads) sb1[i] = b1[i];
  if (tid < NF) sb2[tid] = tid < F ? b2[tid] : 0.f;
}

// 3xTF32 with the small terms apart: big += ah.bh, small += al.bh + ah.bl.
// An MMA's accumulation truncates toward zero, so a long chain of them on
// one accumulator drifts toward zero; here the chain of the large terms
// truncates a third as often, and the small ones' errors are 2^-11 of
// theirs (on an H100, tools/torch_k3b_probe.py: K3B's ds within 1.2e-6 of
// max|ref|, 2.0e-6 on one accumulator).
__device__ __forceinline__ void mma_tf32x3_apart(float (&big)[4], float (&small)[4],
                                                 const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                                 uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                                 uint32_t bl1) {
  mma::mma_tf32(small, al, bh0, bh1);
  mma::mma_tf32(small, ah, bl0, bl1);
  mma::mma_tf32(big, ah, bh0, bh1);
}

// (big, small) += (the f32 values a) . (b0, b1) as mma_tf32x3_apart, each
// value split into its tf32 pair here.
__device__ __forceinline__ void mma_f32x3(float (&big)[4], float (&small)[4],
                                          const float (&a)[4], float b0, float b1) {
  uint32_t av[4], ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int r = 0; r < 4; ++r) av[r] = __float_as_uint(a[r]);
  mma::split_frag(av, ah, al);
  mma::split_tf32(b0, bh0, bl0);
  mma::split_tf32(b1, bh1, bl1);
  mma_tf32x3_apart(big, small, ah, al, bh0, bh1, bl0, bl1);
}

// The forward of one warp on its 16 positions p0.. of the f32 tile zt
// [kTP][C + 4], forward_warp's in 3xTF32:
//   u1 = z k1 + b1   A: z by ldmatrix (tf32_a_offset; rows 16 bytes apart
//                    mod 128), split once a k-step; B: k1 [C][kTfKS] by
//                    32-bit loads (lanes (q, g) on banks 8q + g), split
//   h1 = act(u1)     fno::affine_act_fast (K3F) or fno::act_and_grad_fast
//   o = h1 k2        A from u1's fragments, a k-step's slot q holding unit
//                    2q and slot q + 4 unit 2q + 1; B alike from k2^T by
//                    64-bit loads, NF / 8 n-tiles; the small terms apart
//                    (mma_tf32x3_apart)
// o[n][e] as forward_warp's. With GRAD (K3B), h1 goes to sh [kTP][kTfHS] in
// f32 and u keeps act'(u1); without (K3F), h1 stays in registers.
template <int C, int ACT, bool GRAD, int NF>
__device__ __forceinline__ void forward_warp_tf32(const float* zt, const float* sk1,
                                                  const float* sk2t, const float* sb1, int p0,
                                                  int lane, float (&u)[16][4],
                                                  float (&o)[NF / 8][4], float* sh) {
  constexpr int ZS = C + 4;
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 bv = *reinterpret_cast<const float2*>(sb1 + nt * 8 + 2 * q);
    u[nt][0] = u[nt][2] = bv.x;
    u[nt][1] = u[nt][3] = bv.y;
  }
#pragma unroll
  for (int ks = 0; ks < C / 8; ++ks) {
    uint32_t fa[4], ah[4], al[4];
    mma::ldmatrix_x4(fa, mma::smem_addr(zt + p0 * ZS + mma::tf32_a_offset(lane, ks * 8, ZS)));
    mma::split_frag(fa, ah, al);
    // b0 = k1[8 ks + q][8 nt + gq], b1 four rows on
    const float* kr = sk1 + (ks * 8 + q) * kTfKS + gq;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      mma::split_tf32(kr[nt * 8], bh0, bl0);
      mma::split_tf32(kr[4 * kTfKS + nt * 8], bh1, bl1);
      mma::mma_tf32x3(u[nt], ah, al, bh0, bh1, bl0, bl1);
    }
  }
  float os[NF / 8][4];   // o's small terms
#pragma unroll
  for (int n = 0; n < NF / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = os[n][0] = os[n][1] = os[n][2] = os[n][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    float hv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (GRAD)
        fno::act_and_grad_fast(u[nt][e], ACT, hv[e], u[nt][e]);
      else
        hv[e] = fno::affine_act_fast(u[nt][e], 1.f, 0.f, ACT);
    }
    if constexpr (GRAD) {
      *reinterpret_cast<float2*>(sh + (p0 + gq) * kTfHS + nt * 8 + 2 * q) =
          make_float2(hv[0], hv[1]);
      *reinterpret_cast<float2*>(sh + (p0 + gq + 8) * kTfHS + nt * 8 + 2 * q) =
          make_float2(hv[2], hv[3]);
    }
    // slots (gq, q), (gq + 8, q), (gq, q + 4), (gq + 8, q + 4)
    const float a[4] = {hv[0], hv[2], hv[1], hv[3]};
#pragma unroll
    for (int n = 0; n < NF / 8; ++n) {
      const float2 kb =
          *reinterpret_cast<const float2*>(sk2t + (8 * n + gq) * kTfKS + nt * 8 + 2 * q);
      mma_f32x3(o[n], os[n], a, kb.x, kb.y);
    }
  }
#pragma unroll
  for (int n = 0; n < NF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += os[n][e];
}

// K3F's tf32 variant: k3f_mma_kernel's persistent grid, ring and f64 sums
// on forward_warp_tf32. ~107 KB of shared memory and no more than 128
// registers: two blocks an SM at C <= 64.
template <int C, int ACT, int NF>
__global__ void __launch_bounds__(kMmaThreads, 2)
    k3f_tf32_kernel(const float* __restrict__ s, const float* __restrict__ target,
                    const float* __restrict__ k1, const float* __restrict__ b1,
                    const float* __restrict__ k2, const float* __restrict__ b2,
                    float* __restrict__ partial, TailDims d) {
  constexpr int ZS = C + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sz = reinterpret_cast<float*>(smem_raw);   // [2 stages][kTP][ZS]
  float* sk1 = sz + 2 * kTP * ZS;                   // [C][kTfKS]
  float* sk2t = sk1 + C * kTfKS;                    // [NF][kTfKS]: k2^T (rows >= F zero)
  float* sb1 = sk2t + NF * kTfKS;
  float* sb2 = sb1 + kH1;                           // [NF]
  double* sred = reinterpret_cast<double*>(sb2 + NF);   // [8 warps]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  load_tf32_weights<C, NF>(k1, b1, k2, b2, d.F, sk1, sk2t, nullptr, sb1, sb2);
  const CropTiles ct(d);
  const int p0 = warp * 16;
  double sse = 0.0;
  int tile = blockIdx.x, it = 0;
  if (tile < ct.ntiles) ct.fetch<C, float, ZS>(s, d, tile, sz);
  for (; tile < ct.ntiles; ++it, tile += gridDim.x) {
    const int stage = it & 1;
    mma::cp_async_wait<0>();
    __syncthreads();   // z of this tile has landed; the previous tile's readers are done
    if (tile + gridDim.x < ct.ntiles)
      ct.fetch<C, float, ZS>(s, d, tile + gridDim.x, sz + (stage ^ 1) * kTP * ZS);
    int bT, h, w0, bt;
    ct.decode(d, tile, bT, h, w0, bt);
    const int P = min(kTP, d.W - w0);
    float u[16][4], o[NF / 8][4];
    forward_warp_tf32<C, ACT, false, NF>(sz + stage * kTP * ZS, sk1, sk2t, sb1, p0, lane, u,
                                         o, nullptr);
#pragma unroll
    for (int n = 0; n < NF / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gq + (e >> 1) * 8, f = 8 * n + 2 * q + (e & 1);
        if (p < P && f < d.F) {
          const float diff =
              o[n][e] + sb2[f] - target[(((size_t)bT * d.H + h) * d.W + w0 + p) * d.F + f];
          sse += (double)(diff * diff);
        }
      }
  }
  write_block_sse(sse, sred, partial);
}

// K3B's tf32 variant: k3b_mma_kernel's plan in 3xTF32. Per tile, each warp
// on its 16 positions runs forward_warp_tf32 (h1 into shared memory, u
// keeping act'(u1)), then
//   do = 2 g (o + b2 - target) f32, into do^T [8][kTfDS]; db2 in registers
//   du = (do k2^T) act'(u1)   tail_du, exact f32
//   ds = du k1^T              A from du's fragments (slots permuted as in
//                             fc2), B from k1 [C][kTfKS] by 64-bit loads,
//                             the small terms apart; written once, f32
// and, once the tile's h1 and do^T are in shared memory, the block's sums
// on hidden units 16 warp .. + 15, a k-step's slot q holding position
// 2q and slot q + 4 position 2q + 1 in A and B alike (32- and 64-bit loads
// on 32 banks): dk2 += h1^T do, then, with du in h1's place, dk1 += z^T du
// and db1 += 1^T du (a row of ones, exact in tf32: its lo part is zero, two
// MMAs). The sums go out every kFlushTf32 tiles (flush_k3b_sums); at C 128 the
// next tile's z is copied after this tile's last read of it (one stage).
template <int C, int ACT, int NF>
__global__ void __launch_bounds__(kMmaThreads, 1)
    k3b_tf32_kernel(const float* __restrict__ s, const float* __restrict__ target,
                    const float* __restrict__ k1, const float* __restrict__ b1,
                    const float* __restrict__ k2, const float* __restrict__ b2,
                    const float* __restrict__ gsc, float* __restrict__ ds,
                    float* __restrict__ partial, TailDims d) {
  constexpr int ZS = C + 4;                        // z row stride (4 mod 32)
  constexpr int STAGES = k3b_tf32_stages(C);
  constexpr int MC = C / 16;   // 16-row tiles of z^T; tile MC is the row of ones
  constexpr int NP = 32;                           // channels of ds a pass takes
  constexpr int NT = NF / 8;                       // fc2's n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sz = reinterpret_cast<float*>(smem_raw);   // [STAGES][kTP][ZS]
  float* sk1 = sz + STAGES * kTP * ZS;              // [C][kTfKS]
  float* sh = sk1 + C * kTfKS;                      // [kTP][kTfHS]: h1, then du
  float* sdot = sh + kTP * kTfHS;                   // [NF][kTfDS]: do^T (rows >= F zero)
  float* sk2t = sdot + NF * kTfDS;                  // [NF][kTfKS]: k2^T (rows >= F zero)
  float* sk2f = sk2t + NF * kTfKS;                  // [kH1][NF]: k2 (columns >= F zero)
  float* sb1 = sk2f + kH1 * NF;
  float* sb2 = sb1 + kH1;                           // [NF]
  float* sred = sb2 + NF;                           // [8 warps][NF]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int F = d.F;
  load_tf32_weights<C, NF>(k1, b1, k2, b2, F, sk1, sk2t, sk2f, sb1, sb2);
  const float g2 = 2.f * gsc[0];
  const CropTiles ct(d);
  const int ntiles = ct.ntiles;
  const int nrows =
      ((ntiles + gridDim.x - 1) / gridDim.x + kFlushTf32 - 1) / kFlushTf32;
  const int n = C * kH1 + kH1 + kH1 * F + F;

  float dk1[MC + 1][2][4];   // as k3b_mma_kernel's
  float dk2[NT][4], dk2s[NT][4];   // dk2s: dk2's small terms
  float db2[NT][2];
#pragma unroll
  for (int mi = 0; mi <= MC; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk1[mi][nt][e] = 0.f;
#pragma unroll
  for (int nf = 0; nf < NT; ++nf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk2[nf][e] = dk2s[nf][e] = 0.f;
    db2[nf][0] = db2[nf][1] = 0.f;
  }
  auto flush = [&](int r) {
#pragma unroll
    for (int nf = 0; nf < NT; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk2[nf][e] += dk2s[nf][e];
        dk2s[nf][e] = 0.f;
      }
    flush_k3b_sums<C, NF>(partial + ((size_t)blockIdx.x * nrows + r) * n, F, dk1, dk2, db2,
                          sred, warp, lane);
  };

  int tile = blockIdx.x, it = 0;
  if (tile < ntiles) ct.fetch<C, float, ZS>(s, d, tile, sz);
  const int p0 = warp * 16;
  for (; tile < ntiles; ++it, tile += gridDim.x) {
    const int stage = STAGES == 2 ? it & 1 : 0;
    mma::cp_async_wait<0>();
    __syncthreads();   // z of this tile has landed; the previous tile's readers are done
    if (STAGES == 2 && tile + gridDim.x < ntiles)
      ct.fetch<C, float, ZS>(s, d, tile + gridDim.x, sz + (stage ^ 1) * kTP * ZS);
    int bT, h, w0, bt;
    ct.decode(d, tile, bT, h, w0, bt);
    const int P = min(kTP, d.W - w0);
    const float* zt = sz + stage * kTP * ZS;

    float u[16][4], o[NT][4];
    forward_warp_tf32<C, ACT, true, NF>(zt, sk1, sk2t, sb1, p0, lane, u, o, sh);

    // do = 2 g (o + b2 - target), zero past the tile's positions and F
    float dv[NT][4];
#pragma unroll
    for (int nf = 0; nf < NT; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gq + (e >> 1) * 8, f = 8 * nf + 2 * q + (e & 1);
        dv[nf][e] = 0.f;
        if (p < P && f < F)
          dv[nf][e] =
              g2 * (o[nf][e] + sb2[f] - target[(((size_t)bT * d.H + h) * d.W + w0 + p) * F + f]);
        sdot[f * kTfDS + p] = dv[nf][e];
      }
      db2[nf][0] += dv[nf][0] + dv[nf][2];
      db2[nf][1] += dv[nf][1] + dv[nf][3];
    }
    tail_du<NF>(dv, sk2f, F, gq, q, u);

    // ds = du k1^T, this warp's positions, NP channels a pass
    float* dsb = ds + (((size_t)bt * d.Hp + h) * d.Wp + w0) * C;
#pragma unroll
    for (int cp = 0; cp < C / NP; ++cp) {
      float acc[NP / 8][4], accs[NP / 8][4];   // accs: the small terms
#pragma unroll
      for (int ct8 = 0; ct8 < NP / 8; ++ct8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ct8][e] = accs[ct8][e] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {   // a k-step: hidden units 8 nt ..
        uint32_t av[4], ah[4], al[4];
        // slots (gq, q), (gq + 8, q), (gq, q + 4), (gq + 8, q + 4)
        av[0] = __float_as_uint(u[nt][0]);
        av[1] = __float_as_uint(u[nt][2]);
        av[2] = __float_as_uint(u[nt][1]);
        av[3] = __float_as_uint(u[nt][3]);
        mma::split_frag(av, ah, al);
#pragma unroll
        for (int ct8 = 0; ct8 < NP / 8; ++ct8) {
          const float2 kb = *reinterpret_cast<const float2*>(
              sk1 + (cp * NP + ct8 * 8 + gq) * kTfKS + nt * 8 + 2 * q);
          uint32_t bh0, bl0, bh1, bl1;
          mma::split_tf32(kb.x, bh0, bl0);
          mma::split_tf32(kb.y, bh1, bl1);
          mma_tf32x3_apart(acc[ct8], accs[ct8], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int ct8 = 0; ct8 < NP / 8; ++ct8)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = p0 + gq + hf * 8;
          if (p < P)
            *reinterpret_cast<float2*>(dsb + (size_t)p * C + cp * NP + ct8 * 8 + 2 * q) =
                make_float2(acc[ct8][2 * hf] + accs[ct8][2 * hf],
                            acc[ct8][2 * hf + 1] + accs[ct8][2 * hf + 1]);
        }
    }
    __syncthreads();   // every warp's h1 and do^T are in shared memory

    // dk2 += h1^T do on hidden units 16 warp .. + 15
#pragma unroll 4
    for (int kp = 2 * q; kp < kTP; kp += 8) {
      const float* hr = sh + kp * kTfHS + 16 * warp + gq;
      const float a[4] = {hr[0], hr[8], hr[kTfHS], hr[kTfHS + 8]};
#pragma unroll
      for (int nf = 0; nf < NT; ++nf) {
        const float2 db = *reinterpret_cast<const float2*>(sdot + (8 * nf + gq) * kTfDS + kp);
        mma_f32x3(dk2[nf], dk2s[nf], a, db.x, db.y);
      }
    }
    __syncthreads();   // h1 is read: du takes its place
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      *reinterpret_cast<float2*>(sh + (p0 + gq) * kTfHS + nt * 8 + 2 * q) =
          make_float2(u[nt][0], u[nt][1]);
      *reinterpret_cast<float2*>(sh + (p0 + gq + 8) * kTfHS + nt * 8 + 2 * q) =
          make_float2(u[nt][2], u[nt][3]);
    }
    __syncthreads();   // every warp's du is in shared memory

    // dk1 += z^T du and db1 += 1^T du on hidden units 16 warp .. + 15
    const uint32_t one = gq == 0 ? 0x3F800000u : 0u;   // row 0 of the ones tile: 1.0
    const uint32_t ones[4] = {one, 0u, one, 0u};
#pragma unroll 2
    for (int kp = 2 * q; kp < kTP; kp += 8) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* dr = sh + kp * kTfHS + 16 * warp + nt * 8 + gq;
        mma::split_tf32(dr[0], bh[nt][0], bl[nt][0]);
        mma::split_tf32(dr[kTfHS], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MC; ++mi) {
        const float* zr = zt + kp * ZS + mi * 16 + gq;
        uint32_t av[4] = {__float_as_uint(zr[0]), __float_as_uint(zr[8]), __float_as_uint(zr[ZS]),
                          __float_as_uint(zr[ZS + 8])};
        uint32_t ah[4], al[4];
        mma::split_frag(av, ah, al);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma::mma_tf32x3(dk1[mi][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma::mma_tf32(dk1[MC][nt], ones, bl[nt][0], bl[nt][1]);
        mma::mma_tf32(dk1[MC][nt], ones, bh[nt][0], bh[nt][1]);
      }
    }
    if ((it + 1) % kFlushTf32 == 0) flush(it / kFlushTf32);
    if (STAGES == 1 && tile + gridDim.x < ntiles) {
      __syncthreads();   // every warp's reads of z are done
      ct.fetch<C, float, ZS>(s, d, tile + gridDim.x, sz);
    }
  }
  // the last rows: the sums of a group under kFlushTf32 tiles, then zeros
  for (int r = it / kFlushTf32; r < nrows; ++r) flush(r);
  zero_outside_crop<C>(ds, d);
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

// Calls fn(C, ACT, NF) (as std::integral_constant arguments) for an
// instantiated (width, activation, NF = fc2_width(F)) of the tensor-core
// variants, four kernels each: every width with the two GELUs the tail
// takes (ops/activations.py::gelu_variant) at NF 8, and at NF 16 the
// combustion scenario's (C 64, exact) alone (ops/kernels.py::
// K3_WIDE_F_INSTANCES); cudaErrorInvalidValue for any other.
template <typename Fn>
cudaError_t with_mma_instance(int C, int act, int F, Fn&& fn) {
  using std::integral_constant;
  const int NF = fc2_width(F);
#define MMA_INSTANCE(CC, AA, NN)                                                            \
  if (C == CC && act == AA && NF == NN)                                                     \
  return fn(integral_constant<int, CC>(), integral_constant<int, AA>(),                     \
            integral_constant<int, NN>())
  MMA_INSTANCE(64, fno::kActExact, 8);    // the cylinder
  MMA_INSTANCE(64, fno::kActExact, 16);   // the combustion scenario (F 16)
  MMA_INSTANCE(128, fno::kActExact, 8);   // fsi
  MMA_INSTANCE(32, fno::kActExact, 8);
  MMA_INSTANCE(32, fno::kActTanh, 8);
  MMA_INSTANCE(64, fno::kActTanh, 8);
  MMA_INSTANCE(128, fno::kActTanh, 8);
#undef MMA_INSTANCE
  return cudaErrorInvalidValue;
}

long long crop_tiles(const TailDims& d) {
  return (long long)d.B * d.T * d.H * ((d.W + kTP - 1) / kTP);
}

// A persistent grid: as many blocks of `kernel` as the card's SMs hold at
// once with `smem` bytes each, never more than tiles; 0 on error.
template <typename K>
int persistent_blocks(K kernel, int smem, const TailDims& d) {
  int dev = 0, sms = 0, per_sm = 0;
  if (fno::allow_smem(kernel, (size_t)smem) != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem) !=
          cudaSuccess)
    return 0;
  const long long n = std::min(crop_tiles(d), (long long)sms * per_sm);
  return n < 1 ? 0 : (int)n;
}

// Rows of partial sums of K3B's tensor-core variant (1 mma, 2 tf32):
// flush_tiles(variant) tiles a row, as many rows a block as the most tiles a
// block takes need (nrows of k3b_mma_kernel and k3b_tf32_kernel).
int k3b_tc_rows(const TailDims& d, int nblocks, int variant) {
  const long long per_block = (crop_tiles(d) + nblocks - 1) / nblocks;
  const int tiles = flush_tiles(variant);
  return nblocks * (int)((per_block + tiles - 1) / tiles);
}

// Blocks of a tensor-core variant's grid (variant 1 mma, 2 tf32) at (C,
// act, F), as many as the shared memory lets the SMs hold: K3B's one an
// SM, K3F's two at C <= 64; 0 on error.
int k3b_tc_blocks(const TailDims& d, int variant) {
  int nblocks = 0;
  with_mma_instance(d.C, d.act, d.F, [&](auto c, auto a, auto nf) {
    constexpr int CC = decltype(c)::value, AA = decltype(a)::value, NN = decltype(nf)::value;
    nblocks = variant == 1
                  ? persistent_blocks(k3b_mma_kernel<CC, AA, NN>, k3b_mma_smem(CC, NN), d)
              : variant == 2
                  ? persistent_blocks(k3b_tf32_kernel<CC, AA, NN>, k3b_tf32_smem(CC, NN), d)
                  : 0;
    return cudaSuccess;
  });
  return nblocks;
}
int k3f_tc_blocks(const TailDims& d, int variant) {
  int nblocks = 0;
  with_mma_instance(d.C, d.act, d.F, [&](auto c, auto a, auto nf) {
    constexpr int CC = decltype(c)::value, AA = decltype(a)::value, NN = decltype(nf)::value;
    nblocks = variant == 1
                  ? persistent_blocks(k3f_mma_kernel<CC, AA, NN>, k3f_mma_smem(CC, NN), d)
              : variant == 2
                  ? persistent_blocks(k3f_tf32_kernel<CC, AA, NN>, k3f_tf32_smem(CC, NN), d)
                  : 0;
    return cudaSuccess;
  });
  return nblocks;
}

// variant 1: bf16 s and ds (mma), 2: f32 (tf32).
cudaError_t launch_k3b_tc(int variant, const void* s, const void* target, const void* k1,
                          const void* b1, const void* k2, const void* b2, const void* g,
                          void* ds, void* partial, void* out, const TailDims& d,
                          cudaStream_t stream) {
  for (const void* p : {s, (const void*)ds})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int nblocks = k3b_tc_blocks(d, variant);
  if (nblocks < 1) return cudaErrorInvalidValue;
  const float *tg = static_cast<const float*>(target), *w1 = static_cast<const float*>(k1),
              *v1 = static_cast<const float*>(b1), *w2 = static_cast<const float*>(k2),
              *v2 = static_cast<const float*>(b2), *gs = static_cast<const float*>(g);
  float* part = static_cast<float*>(partial);
  cudaError_t err = with_mma_instance(d.C, d.act, d.F, [&](auto c, auto a, auto nf) {
    constexpr int CC = decltype(c)::value, AA = decltype(a)::value, NN = decltype(nf)::value;
    if (variant == 1)
      k3b_mma_kernel<CC, AA, NN><<<nblocks, kMmaThreads, k3b_mma_smem(CC, NN), stream>>>(
          static_cast<const bf16*>(s), tg, w1, v1, w2, v2, gs, static_cast<bf16*>(ds), part, d);
    else
      k3b_tf32_kernel<CC, AA, NN><<<nblocks, kMmaThreads, k3b_tf32_smem(CC, NN), stream>>>(
          static_cast<const float*>(s), tg, w1, v1, w2, v2, gs, static_cast<float*>(ds), part,
          d);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(part, static_cast<float*>(out),
                              k3b_tc_rows(d, nblocks, variant),
                              d.C * kH1 + kH1 + kH1 * d.F + d.F, stream);
}

cudaError_t launch_k3f_tc(int variant, const void* s, const void* target, const void* k1,
                          const void* b1, const void* k2, const void* b2, void* partial,
                          void* sse, const TailDims& d, cudaStream_t stream) {
  if ((uintptr_t)s % 16) return cudaErrorMisalignedAddress;
  const int nblocks = k3f_tc_blocks(d, variant);
  if (nblocks < 1) return cudaErrorInvalidValue;
  const float *tg = static_cast<const float*>(target), *w1 = static_cast<const float*>(k1),
              *v1 = static_cast<const float*>(b1), *w2 = static_cast<const float*>(k2),
              *v2 = static_cast<const float*>(b2);
  float* part = static_cast<float*>(partial);
  cudaError_t err = with_mma_instance(d.C, d.act, d.F, [&](auto c, auto a, auto nf) {
    constexpr int CC = decltype(c)::value, AA = decltype(a)::value, NN = decltype(nf)::value;
    if (variant == 1)
      k3f_mma_kernel<CC, AA, NN><<<nblocks, kMmaThreads, k3f_mma_smem(CC, NN), stream>>>(
          static_cast<const bf16*>(s), tg, w1, v1, w2, v2, part, d);
    else
      k3f_tf32_kernel<CC, AA, NN><<<nblocks, kMmaThreads, k3f_tf32_smem(CC, NN), stream>>>(
          static_cast<const float*>(s), tg, w1, v1, w2, v2, part, d);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(part, static_cast<float*>(sse), nblocks, 1, stream);
}

// The dtype a tensor-core variant takes (1 mma: bf16, 2 tf32: f32); -1 for
// any other variant.
int tc_dtype(int variant) { return variant == 1 ? fno::kBF16 : variant == 2 ? fno::kF32 : -1; }

}  // namespace

// Bytes of shared memory a block of K3B's (K3F's) mma or tf32 variant takes
// at width C and fc2 width F.
extern "C" int fno_k3b_mma_smem_bytes(int C, int F) { return k3b_mma_smem(C, fc2_width(F)); }
extern "C" int fno_k3f_mma_smem_bytes(int C, int F) { return k3f_mma_smem(C, fc2_width(F)); }
extern "C" int fno_k3b_tf32_smem_bytes(int C, int F) { return k3b_tf32_smem(C, fc2_width(F)); }
extern "C" int fno_k3f_tf32_smem_bytes(int C, int F) { return k3f_tf32_smem(C, fc2_width(F)); }

// Blocks an SM of the persistent grid of K3F's (kernel 0) or K3B's (1) mma
// (variant 1) or tf32 (2) variant at (C, act, F), from the occupancy query;
// 0 on error.
extern "C" int fno_tail_blocks_per_sm(int kernel, int C, int act, int F, int variant) {
  int per_sm = 0;
  with_mma_instance(C, act, F, [&](auto c, auto a, auto nf) {
    constexpr int CC = decltype(c)::value, AA = decltype(a)::value, NN = decltype(nf)::value;
    auto query = [&](auto k, int smem) {
      if (fno::allow_smem(k, (size_t)smem) == cudaSuccess)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kMmaThreads, smem);
    };
    if (kernel == 0 && variant == 1) query(k3f_mma_kernel<CC, AA, NN>, k3f_mma_smem(CC, NN));
    if (kernel == 0 && variant == 2) query(k3f_tf32_kernel<CC, AA, NN>, k3f_tf32_smem(CC, NN));
    if (kernel == 1 && variant == 1) query(k3b_mma_kernel<CC, AA, NN>, k3b_mma_smem(CC, NN));
    if (kernel == 1 && variant == 2) query(k3b_tf32_kernel<CC, AA, NN>, k3b_tf32_smem(CC, NN));
    return cudaSuccess;
  });
  return per_sm;
}

// Rows of K3B's partial sums for variant 0 (fma: one an image), 1 (mma) or
// 2 (tf32: k3b_tc_rows over its persistent grid); 0 on error.
extern "C" int fno_k3b_num_partials(int B, int T, int H, int W, int Tp, int C, int F, int act,
                                    int variant) {
  if (variant == 0) return B * Tp;
  const TailDims d{T, H, W, Tp, 0, 0, C, F, act, B};
  const int nblocks = k3b_tc_blocks(d, variant);
  return nblocks < 1 ? 0 : k3b_tc_rows(d, nblocks, variant);
}

// Partial sums of K3F for variant 0 (fma: one an image), 1 (mma) or 2
// (tf32: one a block of its persistent grid); 0 on error.
extern "C" int fno_k3f_num_partials(int B, int T, int H, int W, int C, int F, int act,
                                    int variant) {
  if (variant == 0) return B * T;
  const TailDims d{T, H, W, T, 0, 0, C, F, act, B};
  return k3f_tc_blocks(d, variant);
}

// variant: 0 fma, 1 mma (bf16), 2 tf32 (f32) (ops/kernels.py:
// VARIANTS["k3f"]); partial holds fno_k3f_num_partials(...) floats.
extern "C" int fno_k3f(const void* s, const void* target, const void* k1, const void* b1,
                       const void* k2, const void* b2, void* partial, void* sse, int B, int T,
                       int H, int W, int Tp, int Hp, int Wp, int C, int H1, int F, int act,
                       int variant, int dtype, void* stream) {
  const TailDims d{T, H, W, Tp, Hp, Wp, C, F, act, B};
  cudaError_t err = check_dims(d, B, H1);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1 || variant == 2) {
    if (dtype != tc_dtype(variant)) return cudaErrorInvalidValue;
    return launch_k3f_tc(variant, s, target, k1, b1, k2, b2, partial, sse, d, st);
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == fno::kF32) return launch_k3f<float>(s, target, k1, b1, k2, b2, partial, sse, B, d, st);
  if (dtype == fno::kBF16)
    return launch_k3f<__nv_bfloat16>(s, target, k1, b1, k2, b2, partial, sse, B, d, st);
  return cudaErrorInvalidValue;
}

extern "C" int fno_k3b(const void* s, const void* target, const void* k1, const void* b1,
                       const void* k2, const void* b2, const void* g, void* ds, void* partial,
                       void* out, int B, int T, int H, int W, int Tp, int Hp, int Wp, int C,
                       int H1, int F, int act, int variant, int dtype, void* stream) {
  const TailDims d{T, H, W, Tp, Hp, Wp, C, F, act, B};
  cudaError_t err = check_dims(d, B, H1);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1 || variant == 2) {
    if (dtype != tc_dtype(variant)) return cudaErrorInvalidValue;
    return launch_k3b_tc(variant, s, target, k1, b1, k2, b2, g, ds, partial, out, d, st);
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == fno::kF32)
    return launch_k3b<float>(s, target, k1, b1, k2, b2, g, ds, partial, out, B, d, st);
  if (dtype == fno::kBF16)
    return launch_k3b<__nv_bfloat16>(s, target, k1, b1, k2, b2, g, ds, partial, out, B, d, st);
  return cudaErrorInvalidValue;
}
