// TA forward and backward: softmax attention over T at every spatial site,
// per head, in the qkv Dense's token layout.
//   q, k, v, o [nsites, T, h*D] (T = bf16 or f32; nsites = B*S), pb [h, T, T] f32
//   forward:  P = softmax(q_i . k_j + pb[h, i, j]) over j (f32, row max
//             subtracted), o_i = sum_j P_ij v_j, rounded once to T
//   backward: with do, recompute P; dP_ij = do_i . v_j,
//             dS_ij = P_ij (dP_ij - sum_j' P_ij' dP_ij'),
//             dq_i = sum_j dS_ij k_j, dk_j = sum_i dS_ij q_i,
//             dv_j = sum_i P_ij do_i, dpb[h] = sum over all sites of dS.
//
// Replaces realpdebench_tpu/ops/pallas/temporal_attention.py::_ta_fwd_kernel
// and ::_ta_bwd_kernel. The TPU kernels put 128 sites on the lanes with an
// in-kernel transpose and run the T x T products on the VPU; that is a TPU
// layout trick and is not carried over.
//
// The `fma` variants of the forward and the backward (f32 and bf16 tensors
// at head widths or T the other variants do not take): a block takes a tile of
// `ns` consecutive sites, whose q/k/v slabs (T*h*D contiguous elements a
// site) it stages in shared memory with 16-byte loads. A thread takes one
// (site, head, row i): q_i in registers, the row's T scores in a padded
// shared-memory row (odd stride: the threads of a warp, on consecutive
// rows, hit distinct banks), an exact softmax over them, and an f32
// accumulator of D for o_i, written once. Threads of one (site, head) read
// the same k_j / v_j, so a warp's shared loads broadcast. The backward
// keeps P and dS rows of the tile in shared memory: phase A (thread = row
// i) writes P, dS and dq_i; phase B (thread = column j) sums dk_j and dv_j
// over i; phase C adds the tile's dS over its sites into a per-block f64
// [h, T, T] accumulator. Blocks loop over tiles and each writes its
// accumulator as a partial; fno::reduce_partials adds the partials in a
// fixed order, so dpb repeats bit for bit. No atomics. Exact f32 FMAs on
// the CUDA cores from shared memory: FP32 issue bounds them.
//
// The `mma` variants (bf16; d in {16, 32, 64}, T <= 32, at most 8 heads,
// 16-byte aligned q, k, v (and do); chosen by ops/kernels.py::ta_fwd_variant
// and ::ta_bwd_variant; ta_bwd_mma_kernel and ta_fwd_mma_kernel below have
// the designs): one warp a (site, head) runs the T x T x d products on
// mma.sync (two in the forward, five in the backward) with the softmax in
// the accumulator fragments (one device function, ta_frag_softmax, for
// both), a persistent grid walking the sites through a cp.async ring.
//
// The `tf32` variants (f32 tensors at the mma variants' shapes, the block
// within the shared memory; ta_bwd_tf32_kernel and ta_fwd_tf32_kernel
// below): the mma variants' plan on f32 rows, every product 3xTF32 on
// mma.sync m16n8k8 (mma.cuh's split_tf32 and mma_tf32x3). S and dP read
// their operands by ldmatrix; the products after the softmax are taken
// transposed (M over the channels) with their k order permuted, so that P
// and dS serve as B fragments straight from the accumulators (o, dq) or by
// two warp shuffles (dk, dv): f32 has no ldmatrix.trans, and no P / dS
// tile is kept.
//
// Bound at the UNet's level 0 (B 12, S 8192, T 20, h 4, D 32, bf16): the
// forward moves 2.0 GB (q, k, v read, o written: 0.60 ms at 3.35 TB/s) for
// 20 GFLOP, the backward 3.5 GB (1.05 ms) for 50 GFLOP: HBM bounds both;
// in f32 twice the bytes (1.20 and 2.10 ms).
#include "fno_common.cuh"
#include "mma.cuh"

#include <math.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;        // tasks (site, head, row) per block, at most
constexpr size_t kFwdSmem = 64 * 1024;  // tile budget: 3 blocks an SM
constexpr size_t kBwdSmem = 110 * 1024; // 2 blocks an SM
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kBwdBlocks = 1024;        // grid cap of the backward: fixes the partials

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

// One 16-byte vector of T at p (16-byte aligned) <-> Vec<T>::n floats.
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 v = __bfloat1622float2(b[t]);
    f[2 * t] = v.x;
    f[2 * t + 1] = v.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) b[t] = __floats2bfloat162_rn(f[2 * t], f[2 * t + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, int D>
__device__ __forceinline__ void load_row(const T* p, float (&r)[D]) {
#pragma unroll
  for (int c = 0; c < D; c += Vec<T>::n) load_vec(p + c, r + c);
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, const float (&r)[D]) {
#pragma unroll
  for (int c = 0; c < D; c += Vec<T>::n) store_vec(p + c, r + c);
}

// a . row(p)
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float (&a)[D], const T* p) {
  constexpr int V = Vec<T>::n;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += V) {
    float f[V];
    load_vec(p + c, f);
#pragma unroll
    for (int t = 0; t < V; ++t) acc = fmaf(a[c + t], f[t], acc);
  }
  return acc;
}

// acc += w * row(p)
template <typename T, int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float w, const T* p) {
  constexpr int V = Vec<T>::n;
#pragma unroll
  for (int c = 0; c < D; c += V) {
    float f[V];
    load_vec(p + c, f);
#pragma unroll
    for (int t = 0; t < V; ++t) acc[c + t] = fmaf(w, f[t], acc[c + t]);
  }
}

// Copy n elements (a multiple of one 16-byte vector) from global to shared.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n) {
  const int nv = n / Vec<T>::n;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d[i] = s[i];
}

struct TaShape {
  int nsites, T, h;
  int ns;  // sites per tile
  int tp;  // padded length of a score row (odd)
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Shared-memory layouts, in bytes from the base (host and device agree).
struct FwdLayout {
  size_t k, v, pb, sc, total;
  __host__ __device__ FwdLayout(const TaShape& s, int F, int es) {
    const size_t slab = (size_t)s.ns * s.T * F * es;
    k = 0;
    v = k + slab;
    pb = v + slab;
    sc = align16(pb + (size_t)s.h * s.T * s.T * 4);
    total = sc + (size_t)s.ns * s.h * s.T * s.tp * 4;
  }
};

struct BwdLayout {
  size_t acc, pb, p, ds, q, k, v, dout, total;
  __host__ __device__ BwdLayout(const TaShape& s, int F, int es) {
    const size_t nhT = (size_t)s.h * s.T * s.T;
    const size_t rows = (size_t)s.ns * s.h * s.T * s.tp * 4;
    const size_t slab = (size_t)s.ns * s.T * F * es;
    acc = 0;
    pb = align16(acc + nhT * 8);
    p = align16(pb + nhT * 4);
    ds = p + rows;
    q = align16(ds + rows);
    k = q + slab;
    v = k + slab;
    dout = v + slab;
    total = dout + slab;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
    ta_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ pb, T* __restrict__ o, TaShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = s.h * D;
  const int slab = s.T * F;
  const FwdLayout L(s, F, sizeof(T));
  T* sk = reinterpret_cast<T*>(smem + L.k);
  T* sv = reinterpret_cast<T*>(smem + L.v);
  float* spb = reinterpret_cast<float*>(smem + L.pb);
  float* ssc = reinterpret_cast<float*>(smem + L.sc);

  const int site0 = blockIdx.x * s.ns;
  const int nhere = min(s.ns, s.nsites - site0);
  stage(sk, k + (size_t)site0 * slab, nhere * slab);
  stage(sv, v + (size_t)site0 * slab, nhere * slab);
  for (int e = threadIdx.x; e < s.h * s.T * s.T; e += blockDim.x) spb[e] = pb[e];
  __syncthreads();

  const int task = threadIdx.x;
  if (task >= nhere * s.h * s.T) return;  // no barrier below
  const int i = task % s.T;
  const int hh = (task / s.T) % s.h;
  const int st = task / (s.T * s.h);
  const size_t row = ((size_t)(site0 + st) * s.T + i) * F + hh * D;
  float qi[D];
  load_row<T, D>(q + row, qi);
  float* sc = ssc + task * s.tp;
  const float* pbi = spb + (hh * s.T + i) * s.T;
  const T* kb = sk + st * slab + hh * D;
  float m = -INFINITY;
  for (int j = 0; j < s.T; ++j) {
    const float x = dot_row<T, D>(qi, kb + j * F) + pbi[j];
    sc[j] = x;
    m = fmaxf(m, x);
  }
  float l = 0.f;
  for (int j = 0; j < s.T; ++j) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    l += e;
  }
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  const T* vb = sv + st * slab + hh * D;
  for (int j = 0; j < s.T; ++j) axpy_row<T, D>(acc, sc[j] / l, vb + j * F);
  store_row<T, D>(o + row, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads)
    ta_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ pb, const T* __restrict__ dout, T* __restrict__ dq,
                  T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partial,
                  TaShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = s.h * D;
  const int slab = s.T * F;
  const int nhT = s.h * s.T * s.T;
  const BwdLayout L(s, F, sizeof(T));
  double* sacc = reinterpret_cast<double*>(smem + L.acc);
  float* spb = reinterpret_cast<float*>(smem + L.pb);
  float* sp = reinterpret_cast<float*>(smem + L.p);
  float* sds = reinterpret_cast<float*>(smem + L.ds);
  T* sq = reinterpret_cast<T*>(smem + L.q);
  T* sk = reinterpret_cast<T*>(smem + L.k);
  T* sv = reinterpret_cast<T*>(smem + L.v);
  T* sdo = reinterpret_cast<T*>(smem + L.dout);
  for (int e = threadIdx.x; e < nhT; e += blockDim.x) {
    sacc[e] = 0.0;
    spb[e] = pb[e];
  }

  const int task = threadIdx.x;
  const int r = task % s.T;  // row i in phase A, column j in phase B
  const int hh = (task / s.T) % s.h;
  const int st = task / (s.T * s.h);
  const int ntiles = (s.nsites + s.ns - 1) / s.ns;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's readers are done
    const int site0 = tile * s.ns;
    const int nhere = min(s.ns, s.nsites - site0);
    stage(sq, q + (size_t)site0 * slab, nhere * slab);
    stage(sk, k + (size_t)site0 * slab, nhere * slab);
    stage(sv, v + (size_t)site0 * slab, nhere * slab);
    stage(sdo, dout + (size_t)site0 * slab, nhere * slab);
    __syncthreads();
    const bool active = task < nhere * s.h * s.T;
    const int head_off = st * slab + hh * D;
    const size_t row = ((size_t)(site0 + st) * s.T + r) * F + hh * D;
    float* prow = sp + task * s.tp;
    float* dsrow = sds + task * s.tp;

    if (active) {  // phase A: row i = r
      float a[D];
      load_row<T, D>(sq + head_off + r * F, a);
      const float* pbi = spb + (hh * s.T + r) * s.T;
      float m = -INFINITY;
      for (int j = 0; j < s.T; ++j) {
        const float x = dot_row<T, D>(a, sk + head_off + j * F) + pbi[j];
        prow[j] = x;
        m = fmaxf(m, x);
      }
      float l = 0.f;
      for (int j = 0; j < s.T; ++j) {
        const float e = expf(prow[j] - m);
        prow[j] = e;
        l += e;
      }
      load_row<T, D>(sdo + head_off + r * F, a);
      float dsum = 0.f;
      for (int j = 0; j < s.T; ++j) {
        const float p = prow[j] / l;
        const float dp = dot_row<T, D>(a, sv + head_off + j * F);
        prow[j] = p;
        dsrow[j] = dp;
        dsum = fmaf(p, dp, dsum);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) a[c] = 0.f;
      for (int j = 0; j < s.T; ++j) {
        const float g = prow[j] * (dsrow[j] - dsum);
        dsrow[j] = g;
        axpy_row<T, D>(a, g, sk + head_off + j * F);
      }
      store_row<T, D>(dq + row, a);
    }
    __syncthreads();

    if (active) {  // phase B: column j = r
      float ga[D], gb[D];
#pragma unroll
      for (int c = 0; c < D; ++c) ga[c] = gb[c] = 0.f;
      const int col0 = (st * s.h + hh) * s.T * s.tp + r;
      for (int i = 0; i < s.T; ++i) {
        axpy_row<T, D>(ga, sds[col0 + i * s.tp], sq + head_off + i * F);
        axpy_row<T, D>(gb, sp[col0 + i * s.tp], sdo + head_off + i * F);
      }
      store_row<T, D>(dk + row, ga);
      store_row<T, D>(dv + row, gb);
    }

    // phase C: the tile's dS summed over its sites, in site order
    for (int e = threadIdx.x; e < nhT; e += blockDim.x) {
      const int eh = e / (s.T * s.T);
      const int ij = e - eh * s.T * s.T;
      const int off = (eh * s.T + ij / s.T) * s.tp + ij % s.T;
      double a = 0.0;
      for (int t = 0; t < nhere; ++t) a += (double)sds[t * s.h * s.T * s.tp + off];
      sacc[e] += a;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nhT; e += blockDim.x)
    partial[(size_t)blockIdx.x * nhT + e] = (float)sacc[e];
}

// ---------------------------------------------------------------------------
// TA backward's tensor-core variant (bf16; d in {16, 32, 64}, T <= 32,
// heads <= 8)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTaStages = 2;     // sites in flight a block: the ring's stages
constexpr int kTaMaxHeads = 8;   // warps a block: one a head
constexpr int kTaTS = 40;        // row stride of a warp's [32][32] P / dS tile (bank spread)
// sites a warp's f32 sums of dS take before they go into the block's f64
// accumulator (a CPU replay of the flush at the UNet's level-0 statistics
// put the block partials within 4.4e-8 of the sum of |terms| at 16 sites)
constexpr int kTaFlush = 16;

// Shared memory of a block, in bytes from the base (host and device agree;
// ops/kernels.py::ta_bwd_mma_smem_bytes).
struct TaMmaLayout {
  size_t ring, zero, tiles, acc, bias, total;
  __host__ __device__ TaMmaLayout(int T, int h, int D) {
    const size_t rs = (size_t)h * D + 8;               // a ring row's stride (bank spread)
    const size_t tj = 8 * (size_t)((T + 7) / 8);       // columns padded to 8 NT
    ring = 0;                                          // [kTaStages][q, k, v, do][T][rs] bf16
    zero = ring + (size_t)kTaStages * 4 * T * rs * 2;  // [64] bf16 zeros: every row past T
    tiles = zero + 128;                                // [h][32][kTaTS] bf16: dS, then P
    acc = tiles + (size_t)h * 32 * kTaTS * 2;          // [h][T][T] f64: dpb of the block
    bias = acc + (size_t)h * T * T * 8;                // [h][T][8 NT] f32: pb, -inf past T
    total = bias + (size_t)h * T * tj * 4;
  }
};

// Shared memory of a block of the forward's tensor-core variant (host and
// device agree; ops/kernels.py::ta_fwd_mma_smem_bytes).
struct TaFwdMmaLayout {
  size_t ring, zero, bias, total;
  __host__ __device__ TaFwdMmaLayout(int T, int h, int D) {
    const size_t rs = (size_t)h * D + 8;               // a ring row's stride (bank spread)
    const size_t tj = 8 * (size_t)((T + 7) / 8);       // columns padded to 8 NT
    ring = 0;                                          // [kTaStages][q, k, v][T][rs] bf16
    zero = ring + (size_t)kTaStages * 3 * T * rs * 2;  // [64] bf16 zeros: every row past T
    bias = zero + 128;                                 // [h][T][8 NT] f32: pb, -inf past T
    total = bias + (size_t)h * T * tj * 4;
  }
};

// Row r of a [T][rs] operand at base, or the zero row past T.
__device__ __forceinline__ const bf16* ta_row(const bf16* base, int r, int T, int rs,
                                              const bf16* zero) {
  return r < T ? base + r * rs : zero;
}

// The softmax of one warp's (site, head) in the accumulator fragments of S
// (and of dP with DP), as both tensor-core products leave them: rows i =
// 16 mi + (lane >> 2) + 8 hf, columns j = 8 nj + 2 (lane & 3) + e. S + pb
// (bh: this head's [T][8 NT] bias, -inf past column T) and P = softmax(S +
// pb) over j in place (row max subtracted, row max and sum by quad
// shuffles, rows i >= T zero). With DP (the backward), in the same pass
// over the rows dS = P (dP - sum_j P dP) in dp, added into run (dp and run
// are not touched without DP).
template <int NT, bool DP>
__device__ __forceinline__ void ta_frag_softmax(float (&sp)[(NT + 1) / 2][NT][4],
                                                float (&dp)[(NT + 1) / 2][NT][4],
                                                float (&run)[(NT + 1) / 2][NT][4],
                                                const float* bh, int T, int lane) {
  constexpr int MT = (NT + 1) / 2;
  const int gq = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 16 * mi + gq + 8 * hf;
      float mx = -INFINITY;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const float2 b = i < T ? *reinterpret_cast<const float2*>(bh + i * 8 * NT + 8 * nj + 2 * q4)
                               : make_float2(0.f, 0.f);
        sp[mi][nj][2 * hf] += b.x;
        sp[mi][nj][2 * hf + 1] += b.y;
        mx = fmaxf(mx, fmaxf(sp[mi][nj][2 * hf], sp[mi][nj][2 * hf + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sp[mi][nj][2 * hf + e];
          x = exp2f((x - mx) * 1.4426950408889634f);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = i < T ? 1.f / sum : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sp[mi][nj][2 * hf + e];
          x *= inv;
          if (DP) dot = fmaf(x, dp[mi][nj][2 * hf + e], dot);
        }
      if (DP) {
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
#pragma unroll
        for (int nj = 0; nj < NT; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& g = dp[mi][nj][2 * hf + e];
            g = sp[mi][nj][2 * hf + e] * (g - dot);
            run[mi][nj][2 * hf + e] += g;
          }
      }
    }
}

// One warp's (site, head) of the bf16 tensor-core variants: S = q k^T over
// rows i padded to 16 MT and columns j to 8 NT (MT = ceil(NT / 2)), every
// operand row past T read from the zero row, bf16 operands as they are, f32
// sums; with DP (the backward) also dP = do v^T, its products interleaved
// with those of S; then ta_frag_softmax. The forward and the backward both
// call it.
template <int D, int NT, bool DP>
__device__ __forceinline__ void ta_warp_softmax(const bf16* Qs, const bf16* Ks, const bf16* Os,
                                                const bf16* Vs, const bf16* zero,
                                                const float* bh, int T, int rs, int lane,
                                                float (&sp)[(NT + 1) / 2][NT][4],
                                                float (&dp)[(NT + 1) / 2][NT][4],
                                                float (&run)[(NT + 1) / 2][NT][4]) {
  constexpr int MT = (NT + 1) / 2;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sp[mi][nj][e] = 0.f;
        if (DP) dp[mi][nj][e] = 0.f;
      }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t bk[(NT + 1) / 2][4], bv[(NT + 1) / 2][4];
#pragma unroll
    for (int np = 0; np < (NT + 1) / 2; ++np) {
      int n, kk;
      mma::bt_frag_row(lane, 16 * ks, 16 * np, n, kk);
      mma::ldmatrix_x4(bk[np], mma::smem_addr(ta_row(Ks, n, T, rs, zero) + kk));
      if (DP) mma::ldmatrix_x4(bv[np], mma::smem_addr(ta_row(Vs, n, T, rs, zero) + kk));
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = 16 * mi + (lane & 7) + ((lane >> 3) & 1) * 8, c = 16 * ks + (lane >> 4) * 8;
      uint32_t fq[4], fo[4];
      mma::ldmatrix_x4(fq, mma::smem_addr(ta_row(Qs, r, T, rs, zero) + c));
      if (DP) mma::ldmatrix_x4(fo, mma::smem_addr(ta_row(Os, r, T, rs, zero) + c));
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int np = nj >> 1, hb = 2 * (nj & 1);
        mma::mma_bf16(sp[mi][nj], fq, bk[np][hb], bk[np][hb + 1]);
        if (DP) mma::mma_bf16(dp[mi][nj], fo, bv[np][hb], bv[np][hb + 1]);
      }
    }
  }
  ta_frag_softmax<NT, DP>(sp, dp, run, bh, T, lane);
}

// Rows < T of [16 MT][8 CW] accumulators, rounded to bf16, into the columns
// 8 c0.. of a ring slot [T][rs] of this warp's head.
template <int MT, int CW>
__device__ __forceinline__ void ta_store_rows(bf16* slot, int c0, const float (&o)[MT][CW][4],
                                              int T, int rs, int lane) {
  const int gq = lane >> 2, q4 = lane & 3;
  __syncwarp();   // the warp's reads of the columns it overwrites are done
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * mi + gq + 8 * hf;
      if (r < T)
#pragma unroll
        for (int ct = 0; ct < CW; ++ct)
          *reinterpret_cast<uint32_t*>(slot + r * rs + 8 * (c0 + ct) + 2 * q4) =
              mma::pack_bf16(o[mi][ct][2 * hf], o[mi][ct][2 * hf + 1]);
    }
}

// One warp takes one (site, head), the block's warps the heads of one site,
// the block its sites s = blockIdx.x + i * gridDim.x; the next site's q, k,
// v and do come by 16-byte cp.async into a two-stage ring. A warp's rows i
// and columns j are padded to 16 MT and 8 NT (NT = ceil(T / 8)); every
// operand row past T is read from a row of zeros.
//   S = q k^T, dP = do v^T     mma, bf16 operands as they are, f32 sums
//   P = softmax(S + pb)        in the accumulator fragments: columns j >= T
//                              masked to -inf, rows i >= T zero; row max,
//                              sum and sum(P dP) by quad shuffles
//   dS = P (dP - sum_j P dP)   f32; added into the lane's running dpb sums
//   dq = dS k                  mma, dS rounded once to bf16, its A fragments
//                              packed straight from the accumulators
//   dk = dS^T q, dv = P^T do   mma, dS and then P staged as bf16 in the
//                              warp's tile and read by ldmatrix.trans
// dq, dk and dv round once to bf16 into the warp's columns of the ring
// slots of k, q and v (each slot's last reader is the product that writes
// it), and the block writes the site's three [T, h d] slabs out with 16-byte
// stores (4-byte stores straight from the fragments, 8 rows apart, cost 0.5
// ms of 2.4 at the UNet's level 0: tools/torch_ta_probe.py, cut_store). The
// bias sits in shared memory with -inf past column T. A lane's dS entries sit
// at the same (i, j) at every site: its f32 sums take kTaFlush sites, then
// go into the block's f64 [h, T, T] accumulator (each (i, j) of a head
// belongs to one lane: no atomics); the block writes it as its partial and
// fno::reduce_partials adds the partials in a fixed order.
template <int D, int NT>
__global__ void __launch_bounds__(32 * kTaMaxHeads, 2)
    ta_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ pb,
                      const bf16* __restrict__ dout, bf16* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ partial,
                      int nsites, int T, int h) {
  constexpr int MT = (NT + 1) / 2;      // 16-row tiles over i, and 16-wide k-steps over j
  constexpr int NC = D / 8;             // 8-column tiles of d
  constexpr int CW = NC < 4 ? NC : 4;   // of them a pass of dq, dk or dv takes
  extern __shared__ __align__(16) unsigned char smem[];
  const TaMmaLayout L(T, h, D);
  const int F = h * D, rs = F + 8, slab = T * rs;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  const bf16* zero = reinterpret_cast<const bf16*>(smem + L.zero);
  bf16* tile = reinterpret_cast<bf16*>(smem + L.tiles) + warp * 32 * kTaTS;
  double* acc = reinterpret_cast<double*>(smem + L.acc);
  float* sbias = reinterpret_cast<float*>(smem + L.bias);   // [h][T][8 NT]
  // the zero row; the tiles (their columns past 8 NT are never written);
  // the accumulator; the bias, masked past column T
  for (int i = threadIdx.x; i < (int)((L.acc - L.zero) / 16); i += nthreads)
    reinterpret_cast<uint4*>(smem + L.zero)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < h * T * T; i += nthreads) acc[i] = 0.0;
  for (int i = threadIdx.x; i < h * T * 8 * NT; i += nthreads) {
    const int j = i % (8 * NT), hi = i / (8 * NT);
    sbias[i] = j < T ? pb[hi * T + j] : -INFINITY;
  }

  auto fetch = [&](int site, int stage) {
    bf16* dst = ring + stage * 4 * slab;
    const int per_row = F / 8;
    for (int i = threadIdx.x; i < 4 * T * per_row; i += nthreads) {
      const int t = i / (T * per_row), rem = i - t * T * per_row;
      const int r = rem / per_row, cc = rem - r * per_row;
      const bf16* src = t == 0 ? q : t == 1 ? k : t == 2 ? v : dout;
      mma::cp_async_16(dst + t * slab + r * rs + cc * 8, src + ((size_t)site * T + r) * F + cc * 8);
    }
    mma::cp_async_commit();
  };
  auto row = [&](const bf16* base, int r) { return ta_row(base, r, T, rs, zero); };
  auto store = [&](bf16* slot, int c0, const float (&o)[MT][CW][4]) {
    ta_store_rows<MT, CW>(slot, c0, o, T, rs, lane);
  };
  // out = A^T b over rows of b (i), A^T's fragments read transposed from the
  // warp's tile [i][j], into the slot: dk from (dS, q), dv from (P, do)
  auto tile_product = [&](bf16* slot, const bf16* b) {
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += CW) {
      float o[MT][CW][4] = {};
#pragma unroll
      for (int ki = 0; ki < MT; ++ki) {
        uint32_t fa[MT][4];
#pragma unroll
        for (int mj = 0; mj < MT; ++mj) {
          int kr, m;
          mma::at_frag_row(lane, 16 * ki, 16 * mj, kr, m);
          mma::ldmatrix_x4_trans(fa[mj], mma::smem_addr(tile + kr * kTaTS + m));
        }
#pragma unroll
        for (int cp = 0; cp < CW / 2; ++cp) {
          int kr, n;
          mma::b_frag_row(lane, 16 * ki, 8 * c0 + 16 * cp, kr, n);
          uint32_t fb[4];
          mma::ldmatrix_x4_trans(fb, mma::smem_addr(row(b, kr) + n));
#pragma unroll
          for (int mj = 0; mj < MT; ++mj) {
            mma::mma_bf16(o[mj][2 * cp], fa[mj], fb[0], fb[1]);
            mma::mma_bf16(o[mj][2 * cp + 1], fa[mj], fb[2], fb[3]);
          }
        }
      }
      store(slot, c0, o);
    }
  };

  float run[MT][NT][4] = {};   // dS of this warp's (i, j) entries since the last flush
  auto flush = [&]() {
    double* a = acc + warp * T * T;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mi + gq + 8 * (e >> 1), j = 8 * nj + 2 * q4 + (e & 1);
          if (i < T && j < T) a[i * T + j] += (double)run[mi][nj][e];
          run[mi][nj][e] = 0.f;
        }
  };

  // the ring: site blockIdx.x + i gridDim.x in stage i % kTaStages, the
  // next kTaStages - 1 sites in flight (a group each, empty past the end)
  int site = blockIdx.x, it = 0;
  for (int i = 0; i < kTaStages - 1; ++i) {
    if (site + i * (int)gridDim.x < nsites) fetch(site + i * gridDim.x, i);
    else mma::cp_async_commit();
  }
  for (; site < nsites; ++it, site += gridDim.x) {
    const int stage = it % kTaStages;
    mma::cp_async_wait<kTaStages - 2>();
    __syncthreads();   // this site has landed; the readers of the stage refilled next are done
    const int ahead = site + (kTaStages - 1) * gridDim.x;
    if (ahead < nsites) fetch(ahead, (it + kTaStages - 1) % kTaStages);
    else mma::cp_async_commit();
    bf16* const Qs = ring + stage * 4 * slab + warp * D;
    bf16 *const Ks = Qs + slab, *const Vs = Qs + 2 * slab, *const Os = Qs + 3 * slab;

    // S = q k^T, dP = do v^T, P = softmax(S + pb) and dS = P (dP - sum_j P dP),
    // dS into the lane's running dpb sums
    float sp[MT][NT][4], dp[MT][NT][4];
    ta_warp_softmax<D, NT, true>(Qs, Ks, Os, Vs, zero, sbias + warp * T * 8 * NT, T, rs, lane,
                                 sp, dp, run);

    // P and dS as bf16 pairs, in the accumulators' layout; dS into the tile
    uint32_t pp[MT][NT][2], pd[MT][NT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          pp[mi][nj][hf] = mma::pack_bf16(sp[mi][nj][2 * hf], sp[mi][nj][2 * hf + 1]);
          pd[mi][nj][hf] = mma::pack_bf16(dp[mi][nj][2 * hf], dp[mi][nj][2 * hf + 1]);
          *reinterpret_cast<uint32_t*>(tile + (16 * mi + gq + 8 * hf) * kTaTS + 8 * nj + 2 * q4) =
              pd[mi][nj][hf];
        }
    __syncwarp();

    // dq = dS k: dS's A fragments from its accumulators (k-step kk takes
    // the column tiles 2 kk and 2 kk + 1)
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += CW) {
      float o[MT][CW][4] = {};
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
#pragma unroll
        for (int cp = 0; cp < CW / 2; ++cp) {
          int kr, n;
          mma::b_frag_row(lane, 16 * kk, 8 * c0 + 16 * cp, kr, n);
          uint32_t fb[4];
          mma::ldmatrix_x4_trans(fb, mma::smem_addr(row(Ks, kr) + n));
          const int n2 = 2 * kk + 1 < NT ? 2 * kk + 1 : -1;   // past 8 NT: zeros
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const uint32_t fa[4] = {pd[mi][2 * kk][0], pd[mi][2 * kk][1],
                                    n2 < 0 ? 0u : pd[mi][n2 < 0 ? 0 : n2][0],
                                    n2 < 0 ? 0u : pd[mi][n2 < 0 ? 0 : n2][1]};
            mma::mma_bf16(o[mi][2 * cp], fa, fb[0], fb[1]);
            mma::mma_bf16(o[mi][2 * cp + 1], fa, fb[2], fb[3]);
          }
        }
      }
      store(Ks, c0, o);   // dq into k's slot: k's last reader was this product
    }
    tile_product(Qs, Qs);         // dk = dS^T q, into q's slot
    __syncwarp();                 // every lane's reads of dS are done
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(tile + (16 * mi + gq + 8 * hf) * kTaTS + 8 * nj + 2 * q4) =
              pp[mi][nj][hf];
    __syncwarp();
    tile_product(Vs, Os);         // dv = P^T do, into v's slot (read last by dP)
    if ((it + 1) % kTaFlush == 0) flush();
    __syncthreads();   // every warp's dq, dk and dv are in the slots
    const bf16* st = ring + stage * 4 * slab;
    for (int i = threadIdx.x; i < 3 * T * (F / 8); i += nthreads) {
      const int t = i / (T * (F / 8)), rem = i - t * T * (F / 8);
      const int r = rem / (F / 8), cc = rem - r * (F / 8);
      bf16* out = t == 0 ? dq : t == 1 ? dk : dv;
      const bf16* src = st + (t == 0 ? slab : t == 1 ? 0 : 2 * slab) + r * rs + cc * 8;
      *reinterpret_cast<uint4*>(out + ((size_t)site * T + r) * F + cc * 8) =
          *reinterpret_cast<const uint4*>(src);
    }
  }
  flush();
  __syncthreads();
  for (int e = threadIdx.x; e < h * T * T; e += nthreads)
    partial[(size_t)blockIdx.x * h * T * T + e] = (float)acc[e];
}

// TA forward's tensor-core variant (bf16; d in {16, 32, 64}, T <= 32,
// heads <= 8): the backward's design with one product after the softmax.
// One warp takes one (site, head), the block's warps the heads of one site,
// the block its sites s = blockIdx.x + i * gridDim.x; the next site's q, k
// and v come by 16-byte cp.async into a two-stage ring.
//   S = q k^T, P = softmax(S + pb)   ta_warp_softmax, as in the backward
//   o = P v                          mma, P's A fragments packed straight
//                                    from its accumulators as a bf16 hi + lo
//                                    pair (two MMAs), v by ldmatrix.trans
//                                    from the ring, f32 sums
// P is not rounded once: a CPU replay put o 3.7e-3-5.6e-3 of max|ref| from
// the twin that way (T 7/20/32, d 16/32/64), over the 5e-3 line at five of
// nine shapes, the UNet's among them, and 1.8e-3-2.8e-3 with hi + lo, which
// is the rounding of o itself (tests/test_torch_temporal_attention.py).
// o rounds once to bf16 into the warp's columns of q's ring slot (q's last
// reader is S), and the block writes the site's [T, h d] slab with 16-byte
// stores. No accumulator and no fourth slab: 40 KB of shared memory a block
// at the UNet's shape (T 20, 4 heads of 32), four blocks (16 warps) an SM.
template <int D, int NT>
__global__ void __launch_bounds__(32 * kTaMaxHeads, 2)
    ta_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ pb,
                      bf16* __restrict__ o, int nsites, int T, int h) {
  constexpr int MT = (NT + 1) / 2;      // 16-row tiles over i, and 16-wide k-steps over j
  constexpr int NC = D / 8;             // 8-column tiles of d
  constexpr int CW = NC < 4 ? NC : 4;   // of them a pass of o takes
  extern __shared__ __align__(16) unsigned char smem[];
  const TaFwdMmaLayout L(T, h, D);
  const int F = h * D, rs = F + 8, slab = T * rs;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  const bf16* zero = reinterpret_cast<const bf16*>(smem + L.zero);
  float* sbias = reinterpret_cast<float*>(smem + L.bias);   // [h][T][8 NT]
  // the zero row; the bias, masked past column T
  for (int i = threadIdx.x; i < (int)((L.bias - L.zero) / 16); i += nthreads)
    reinterpret_cast<uint4*>(smem + L.zero)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < h * T * 8 * NT; i += nthreads) {
    const int j = i % (8 * NT), hi = i / (8 * NT);
    sbias[i] = j < T ? pb[hi * T + j] : -INFINITY;
  }

  auto fetch = [&](int site, int stage) {
    bf16* dst = ring + stage * 3 * slab;
    const int per_row = F / 8;
    for (int i = threadIdx.x; i < 3 * T * per_row; i += nthreads) {
      const int t = i / (T * per_row), rem = i - t * T * per_row;
      const int r = rem / per_row, cc = rem - r * per_row;
      const bf16* src = t == 0 ? q : t == 1 ? k : v;
      mma::cp_async_16(dst + t * slab + r * rs + cc * 8, src + ((size_t)site * T + r) * F + cc * 8);
    }
    mma::cp_async_commit();
  };

  // the ring: site blockIdx.x + i gridDim.x in stage i % kTaStages, the
  // next kTaStages - 1 sites in flight (a group each, empty past the end)
  int site = blockIdx.x, it = 0;
  for (int i = 0; i < kTaStages - 1; ++i) {
    if (site + i * (int)gridDim.x < nsites) fetch(site + i * gridDim.x, i);
    else mma::cp_async_commit();
  }
  for (; site < nsites; ++it, site += gridDim.x) {
    const int stage = it % kTaStages;
    mma::cp_async_wait<kTaStages - 2>();
    __syncthreads();   // this site has landed; the readers of the stage refilled next are done
    const int ahead = site + (kTaStages - 1) * gridDim.x;
    if (ahead < nsites) fetch(ahead, (it + kTaStages - 1) % kTaStages);
    else mma::cp_async_commit();
    bf16* const Qs = ring + stage * 3 * slab + warp * D;
    const bf16 *const Ks = Qs + slab, *const Vs = Qs + 2 * slab;

    float sp[MT][NT][4];
    ta_warp_softmax<D, NT, false>(Qs, Ks, nullptr, nullptr, zero, sbias + warp * T * 8 * NT, T,
                                  rs, lane, sp, sp, sp);
    // P as bf16 hi + lo pairs, in the accumulators' layout
    uint32_t ph[MT][NT][2], pl[MT][NT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          mma::split_pack(sp[mi][nj][2 * hf], sp[mi][nj][2 * hf + 1], ph[mi][nj][hf],
                          pl[mi][nj][hf]);

    // o = P v: P's A fragments from its accumulators (k-step kk takes the
    // column tiles 2 kk and 2 kk + 1; past 8 NT zeros)
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += CW) {
      float acc[MT][CW][4] = {};
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        const int n2 = 2 * kk + 1 < NT ? 2 * kk + 1 : -1;
#pragma unroll
        for (int cp = 0; cp < CW / 2; ++cp) {
          int kr, n;
          mma::b_frag_row(lane, 16 * kk, 8 * c0 + 16 * cp, kr, n);
          uint32_t fb[4];
          mma::ldmatrix_x4_trans(fb, mma::smem_addr(ta_row(Vs, kr, T, rs, zero) + n));
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const uint32_t ah[4] = {ph[mi][2 * kk][0], ph[mi][2 * kk][1],
                                    n2 < 0 ? 0u : ph[mi][n2 < 0 ? 0 : n2][0],
                                    n2 < 0 ? 0u : ph[mi][n2 < 0 ? 0 : n2][1]};
            const uint32_t al[4] = {pl[mi][2 * kk][0], pl[mi][2 * kk][1],
                                    n2 < 0 ? 0u : pl[mi][n2 < 0 ? 0 : n2][0],
                                    n2 < 0 ? 0u : pl[mi][n2 < 0 ? 0 : n2][1]};
            mma::mma_bf16(acc[mi][2 * cp], ah, fb[0], fb[1]);
            mma::mma_bf16(acc[mi][2 * cp], al, fb[0], fb[1]);
            mma::mma_bf16(acc[mi][2 * cp + 1], ah, fb[2], fb[3]);
            mma::mma_bf16(acc[mi][2 * cp + 1], al, fb[2], fb[3]);
          }
        }
      }
      ta_store_rows<MT, CW>(Qs, c0, acc, T, rs, lane);   // into q's slot: S read it last
    }
    __syncthreads();   // every warp's o is in the slot
    const bf16* st = ring + stage * 3 * slab;
    for (int i = threadIdx.x; i < T * (F / 8); i += nthreads) {
      const int r = i / (F / 8), cc = i - r * (F / 8);
      *reinterpret_cast<uint4*>(o + ((size_t)site * T + r) * F + cc * 8) =
          *reinterpret_cast<const uint4*>(st + r * rs + cc * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// The tf32 variants of TA forward and backward (f32; the mma variants'
// shapes): the mma variants' plan, every product 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

constexpr int kTaTf32Stages = 2;   // sites in flight a block of a tf32 variant
constexpr int kTaPadF = 4;         // f32 padding of a ring row: rows 16 bytes apart mod 128

// Shared memory of a block of the backward's tf32 variant, in bytes from
// the base (host and device agree; ops/kernels.py::ta_bwd_tf32_smem_bytes).
// No P / dS tile: dk and dv take dS and P from the accumulators by warp
// shuffles. 103 KB at the UNet's shape (T 20, 4 heads of 32): two blocks an
// SM.
struct TaTf32Layout {
  size_t ring, zero, acc, bias, total;
  __host__ __device__ TaTf32Layout(int T, int h, int D) {
    const size_t rs = (size_t)h * D + kTaPadF;             // a ring row's stride
    const size_t tj = 8 * (size_t)((T + 7) / 8);           // columns padded to 8 NT
    ring = 0;                                              // [stages][q, k, v, do][T][rs] f32
    zero = ring + (size_t)kTaTf32Stages * 4 * T * rs * 4;  // [64] f32 zeros: every row past T
    acc = zero + 256;                                      // [h][T][T] f64: dpb of the block
    bias = acc + (size_t)h * T * T * 8;                    // [h][T][8 NT] f32: pb, -inf past T
    total = bias + (size_t)h * T * tj * 4;
  }
};

// The forward's (ops/kernels.py::ta_fwd_tf32_smem_bytes): 70 KB at the
// UNet's shape, three blocks an SM.
struct TaFwdTf32Layout {
  size_t ring, zero, bias, total;
  __host__ __device__ TaFwdTf32Layout(int T, int h, int D) {
    const size_t rs = (size_t)h * D + kTaPadF;
    const size_t tj = 8 * (size_t)((T + 7) / 8);
    ring = 0;                                              // [stages][q, k, v][T][rs] f32
    zero = ring + (size_t)kTaTf32Stages * 3 * T * rs * 4;  // [64] f32 zeros
    bias = zero + 256;                                     // [h][T][8 NT] f32
    total = bias + (size_t)h * T * tj * 4;
  }
};

__device__ __forceinline__ const float* ta_row_f(const float* base, int r, int T, int rs,
                                                 const float* zero) {
  return r < T ? base + r * rs : zero;
}

// S = q k^T (and, with DP, dP = do v^T) of one warp's (site, head) in
// 3xTF32, then ta_frag_softmax: ta_warp_softmax's plan on f32 rows. A k-step
// takes 8 of d: q's (do's) A fragments by ldmatrix (mma::tf32_a_offset's
// rows, 16 bytes apart mod 128 on the rows padded by kTaPadF), k's (v's) B
// fragments of two column tiles by ldmatrix (mma::tf32_bt_row); each
// fragment split once into its tf32 pair.
template <int D, int NT, bool DP>
__device__ __forceinline__ void ta_warp_softmax_tf32(const float* Qs, const float* Ks,
                                                     const float* Os, const float* Vs,
                                                     const float* zero, const float* bh, int T,
                                                     int rs, int lane,
                                                     float (&sp)[(NT + 1) / 2][NT][4],
                                                     float (&dp)[(NT + 1) / 2][NT][4],
                                                     float (&run)[(NT + 1) / 2][NT][4]) {
  constexpr int MT = (NT + 1) / 2;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sp[mi][nj][e] = 0.f;
        if (DP) dp[mi][nj][e] = 0.f;
      }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t kh[MT][4], kl[MT][4], vh[MT][4], vl[MT][4];
#pragma unroll
    for (int np = 0; np < MT; ++np) {
      int n, kk;
      mma::tf32_bt_row(lane, 8 * ks, 16 * np, n, kk);
      uint32_t f[4];
      mma::ldmatrix_x4(f, mma::smem_addr(ta_row_f(Ks, n, T, rs, zero) + kk));
      mma::split_frag(f, kh[np], kl[np]);
      if (DP) {
        mma::ldmatrix_x4(f, mma::smem_addr(ta_row_f(Vs, n, T, rs, zero) + kk));
        mma::split_frag(f, vh[np], vl[np]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = 16 * mi + (lane & 7) + ((lane >> 3) & 1) * 8, c = 8 * ks + (lane >> 4) * 4;
      uint32_t f[4], qh[4], ql[4], oh[4], ol[4];
      mma::ldmatrix_x4(f, mma::smem_addr(ta_row_f(Qs, r, T, rs, zero) + c));
      mma::split_frag(f, qh, ql);
      if (DP) {
        mma::ldmatrix_x4(f, mma::smem_addr(ta_row_f(Os, r, T, rs, zero) + c));
        mma::split_frag(f, oh, ol);
      }
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const int np = nj >> 1, hb = 2 * (nj & 1);
        mma::mma_tf32x3(sp[mi][nj], qh, ql, kh[np][hb], kh[np][hb + 1], kl[np][hb],
                        kl[np][hb + 1]);
        if (DP)
          mma::mma_tf32x3(dp[mi][nj], oh, ol, vh[np][hb], vh[np][hb + 1], vl[np][hb],
                          vl[np][hb + 1]);
      }
    }
  }
  ta_frag_softmax<NT, DP>(sp, dp, run, bh, T, lane);
}

// The A fragments of a transposed product, out^T = A^T X over the rows r of
// A (the k dimension): A^T's rows are the channels 16 mc + g (+ 8) of the
// warp's [T][rs] operand A, its k slots q and q + 4 the rows r0 + 2q and r0
// + 2q + 1 (permuted alike in B), read by 32-bit loads (banks 8q + g), rows
// past T from the zero row; split into tf32 pairs.
template <int CP>
__device__ __forceinline__ void ta_tf32_at_frags(const float* A, int r0, int c0,
                                                 const float* zero, int T, int rs, int lane,
                                                 uint32_t (&ah)[CP][4], uint32_t (&al)[CP][4]) {
  const int gq = lane >> 2, q4 = lane & 3;
  const float* ra = ta_row_f(A, r0 + 2 * q4, T, rs, zero);
  const float* rb = ta_row_f(A, r0 + 2 * q4 + 1, T, rs, zero);
#pragma unroll
  for (int mc = 0; mc < CP; ++mc) {
    const int c = 16 * (c0 + mc) + gq;
    const uint32_t v[4] = {__float_as_uint(ra[c]), __float_as_uint(ra[c + 8]),
                           __float_as_uint(rb[c]), __float_as_uint(rb[c + 8])};
    mma::split_frag(v, ah[mc], al[mc]);
  }
}

// out^T [c][n] accumulators (c = 16 (c0 + mc) + g (+ 8), n = 8 nt + 2q (+ 1))
// into the rows n < T of the warp's [T][rs] slot: 32-bit stores, banks 8q + g.
template <int CP, int NT>
__device__ __forceinline__ void ta_tf32_store_t(float* slot, int c0, const float (&o)[CP][NT][4],
                                                int T, int rs, int lane) {
  const int gq = lane >> 2, q4 = lane & 3;
  __syncwarp();   // the warp's reads of the columns it overwrites are done
#pragma unroll
  for (int mc = 0; mc < CP; ++mc)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * nt + 2 * q4 + (e & 1), c = 16 * (c0 + mc) + gq + 8 * (e >> 1);
        if (n < T) slot[n * rs + c] = o[mc][nt][e];
      }
}

// out = X A, out[i][c] = sum_j X[i][j] A[j][c]: X (P or dS) in the
// accumulator fragments, A (v or k) the warp's [T][rs] rows. Computed as
// out^T = A^T X^T (M over the channels, N over i padded to 8 NT only, K over
// j), so X^T's B fragments are the lane's own accumulators: with A's k slots
// permuted (ta_tf32_at_frags), b0 = X[8 ni + g][8 kj + 2q] and b1 = X[8 ni +
// g][8 kj + 2q + 1]. 32 channels a pass; out into the warp's columns of slot.
template <int D, int NT>
__device__ __forceinline__ void ta_tf32_xa(float* slot, const float* A, const float* zero,
                                           const float (&x)[(NT + 1) / 2][NT][4], int T, int rs,
                                           int lane) {
  constexpr int MC = D / 16, CP = MC < 2 ? MC : 2;
#pragma unroll
  for (int c0 = 0; c0 < MC; c0 += CP) {
    float o[CP][NT][4] = {};
#pragma unroll
    for (int kj = 0; kj < NT; ++kj) {
      uint32_t ah[CP][4], al[CP][4];
      ta_tf32_at_frags<CP>(A, 8 * kj, c0, zero, T, rs, lane, ah, al);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const float* xb = x[ni >> 1][kj] + 2 * (ni & 1);
        uint32_t bh0, bl0, bh1, bl1;
        mma::split_tf32(xb[0], bh0, bl0);
        mma::split_tf32(xb[1], bh1, bl1);
#pragma unroll
        for (int mc = 0; mc < CP; ++mc)
          mma::mma_tf32x3(o[mc][ni], ah[mc], al[mc], bh0, bh1, bl0, bl1);
      }
    }
    ta_tf32_store_t<CP, NT>(slot, c0, o, T, rs, lane);
  }
}

// out = X^T A, out[j][c] = sum_i X[i][j] A[i][c]: X (dS or P) in the
// accumulator fragments, A (q or do) the warp's [T][rs] rows. Computed as
// out^T = A^T X (M over the channels, N over j, K over i padded to 8 NT),
// A's k slots permuted (ta_tf32_at_frags). X's B fragments, b0 = X[8 ki +
// 2q][8 nj + g] and b1 = X[8 ki + 2q + 1][8 nj + g], lie in the lanes (2q +
// e, g >> 1) as register e = g & 1: two shuffles, each source lane sending
// the register that its readers in that round want (lane (g', q') the one of
// parity g' & 1 in the first, the other in the second).
template <int D, int NT>
__device__ __forceinline__ void ta_tf32_xta(float* slot, const float* A, const float* zero,
                                            const float (&x)[(NT + 1) / 2][NT][4], int T, int rs,
                                            int lane) {
  constexpr int MC = D / 16, CP = MC < 2 ? MC : 2;
  const int gq = lane >> 2, q4 = lane & 3, odd = gq & 1;
  const int src1 = 4 * (2 * q4 + odd) + (gq >> 1), src2 = 4 * (2 * q4 + 1 - odd) + (gq >> 1);
#pragma unroll
  for (int c0 = 0; c0 < MC; c0 += CP) {
    float o[CP][NT][4] = {};
#pragma unroll
    for (int ki = 0; ki < NT; ++ki) {
      uint32_t ah[CP][4], al[CP][4];
      ta_tf32_at_frags<CP>(A, 8 * ki, c0, zero, T, rs, lane, ah, al);
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const float* xr = x[ki >> 1][nj] + 2 * (ki & 1);   // rows 8 ki + g, columns 8 nj + 2q (+1)
        const float r1 = __shfl_sync(0xffffffffu, odd ? xr[1] : xr[0], src1);
        const float r2 = __shfl_sync(0xffffffffu, odd ? xr[0] : xr[1], src2);
        uint32_t bh0, bl0, bh1, bl1;
        mma::split_tf32(odd ? r2 : r1, bh0, bl0);
        mma::split_tf32(odd ? r1 : r2, bh1, bl1);
#pragma unroll
        for (int mc = 0; mc < CP; ++mc)
          mma::mma_tf32x3(o[mc][nj], ah[mc], al[mc], bh0, bh1, bl0, bl1);
      }
    }
    ta_tf32_store_t<CP, NT>(slot, c0, o, T, rs, lane);
  }
}

// TA backward's tf32 variant (f32; d in {16, 32, 64}, T <= 32, heads <= 8,
// the block within the shared memory): ta_bwd_mma_kernel's persistent grid,
// cp.async ring (of f32 rows), softmax and dpb sums, every product 3xTF32.
//   S = q k^T, dP = do v^T     ta_warp_softmax_tf32
//   P, dS                      ta_frag_softmax, dS into the lane's dpb sums
//   dq = dS k                  ta_tf32_xa: dS's B fragments its accumulators
//   dk = dS^T q, dv = P^T do   ta_tf32_xta: dS's and P's B fragments by
//                              shuffles
// f32 has no ldmatrix.trans, so the transposed products take their
// operands from the ring rows by 32-bit loads and from the accumulators as
// they lie, and no P / dS tile is kept: 103 KB of shared memory a block at
// the UNet's shape, two blocks (8 warps) an SM. dq, dk and dv go into the
// warp's columns of the slots of k, q and v (each slot's last reader is the
// product that writes it; v's is dP), and the block writes the site's
// three [T, h d] slabs out with 16-byte stores.
template <int D, int NT>
__global__ void __launch_bounds__(32 * kTaMaxHeads, 1)
    ta_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ pb,
                       const float* __restrict__ dout, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ partial,
                       int nsites, int T, int h) {
  constexpr int MT = (NT + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const TaTf32Layout L(T, h, D);
  const int F = h * D, rs = F + kTaPadF, slab = T * rs;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  const float* zero = reinterpret_cast<const float*>(smem + L.zero);
  double* acc = reinterpret_cast<double*>(smem + L.acc);
  float* sbias = reinterpret_cast<float*>(smem + L.bias);   // [h][T][8 NT]
  for (int i = threadIdx.x; i < (int)((L.acc - L.zero) / 16); i += nthreads)
    reinterpret_cast<uint4*>(smem + L.zero)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < h * T * T; i += nthreads) acc[i] = 0.0;
  for (int i = threadIdx.x; i < h * T * 8 * NT; i += nthreads) {
    const int j = i % (8 * NT), hi = i / (8 * NT);
    sbias[i] = j < T ? pb[hi * T + j] : -INFINITY;
  }

  auto fetch = [&](int site, int stage) {
    float* dst = ring + stage * 4 * slab;
    const int per_row = F / 4;
    for (int i = threadIdx.x; i < 4 * T * per_row; i += nthreads) {
      const int t = i / (T * per_row), rem = i - t * T * per_row;
      const int r = rem / per_row, cc = rem - r * per_row;
      const float* src = t == 0 ? q : t == 1 ? k : t == 2 ? v : dout;
      mma::cp_async_16(dst + t * slab + r * rs + cc * 4, src + ((size_t)site * T + r) * F + cc * 4);
    }
    mma::cp_async_commit();
  };

  float run[MT][NT][4] = {};   // dS of this warp's (i, j) entries since the last flush
  auto flush = [&]() {
    double* a = acc + warp * T * T;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mi + gq + 8 * (e >> 1), j = 8 * nj + 2 * q4 + (e & 1);
          if (i < T && j < T) a[i * T + j] += (double)run[mi][nj][e];
          run[mi][nj][e] = 0.f;
        }
  };

  // the ring: site blockIdx.x + i gridDim.x in stage i % kTaTf32Stages, the
  // next kTaTf32Stages - 1 sites in flight (a group each, empty past the end)
  int site = blockIdx.x, it = 0;
  for (int i = 0; i < kTaTf32Stages - 1; ++i) {
    if (site + i * (int)gridDim.x < nsites) fetch(site + i * gridDim.x, i);
    else mma::cp_async_commit();
  }
  for (; site < nsites; ++it, site += gridDim.x) {
    const int stage = it % kTaTf32Stages;
    mma::cp_async_wait<kTaTf32Stages - 2>();
    __syncthreads();   // this site has landed; the readers of the stage refilled next are done
    const int ahead = site + (kTaTf32Stages - 1) * gridDim.x;
    if (ahead < nsites) fetch(ahead, (it + kTaTf32Stages - 1) % kTaTf32Stages);
    else mma::cp_async_commit();
    float* const Qs = ring + stage * 4 * slab + warp * D;
    float *const Ks = Qs + slab, *const Vs = Qs + 2 * slab, *const Os = Qs + 3 * slab;

    float sp[MT][NT][4], dp[MT][NT][4];
    ta_warp_softmax_tf32<D, NT, true>(Qs, Ks, Os, Vs, zero, sbias + warp * T * 8 * NT, T, rs,
                                      lane, sp, dp, run);
    ta_tf32_xa<D, NT>(Ks, Ks, zero, dp, T, rs, lane);    // dq = dS k, into k's slot
    ta_tf32_xta<D, NT>(Qs, Qs, zero, dp, T, rs, lane);   // dk = dS^T q, into q's slot
    ta_tf32_xta<D, NT>(Vs, Os, zero, sp, T, rs, lane);   // dv = P^T do, into v's slot
    if ((it + 1) % kTaFlush == 0) flush();
    __syncthreads();   // every warp's dq, dk and dv are in the slots
    const float* st = ring + stage * 4 * slab;
    for (int i = threadIdx.x; i < 3 * T * (F / 4); i += nthreads) {
      const int t = i / (T * (F / 4)), rem = i - t * T * (F / 4);
      const int r = rem / (F / 4), cc = rem - r * (F / 4);
      float* out = t == 0 ? dq : t == 1 ? dk : dv;
      const float* src = st + (t == 0 ? slab : t == 1 ? 0 : 2 * slab) + r * rs + cc * 4;
      *reinterpret_cast<float4*>(out + ((size_t)site * T + r) * F + cc * 4) =
          *reinterpret_cast<const float4*>(src);
    }
  }
  flush();
  __syncthreads();
  for (int e = threadIdx.x; e < h * T * T; e += nthreads)
    partial[(size_t)blockIdx.x * h * T * T + e] = (float)acc[e];
}

// TA forward's tf32 variant (f32; the backward's shapes): ta_fwd_mma_kernel's
// plan on f32 rows, every product 3xTF32.
//   S = q k^T, P = softmax(S + pb)   ta_warp_softmax_tf32
//   o = P v                          ta_tf32_xa: P's B fragments its
//                                    accumulators, v by 32-bit loads
// o goes into the warp's columns of q's ring slot (q's last reader is S),
// and the block writes the site's [T, h d] slab with 16-byte stores. 70 KB
// of shared memory a block at the UNet's shape: three blocks (12 warps) an
// SM.
template <int D, int NT>
__global__ void __launch_bounds__(32 * kTaMaxHeads, 2)
    ta_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ pb,
                       float* __restrict__ o, int nsites, int T, int h) {
  constexpr int MT = (NT + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const TaFwdTf32Layout L(T, h, D);
  const int F = h * D, rs = F + kTaPadF, slab = T * rs;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  const float* zero = reinterpret_cast<const float*>(smem + L.zero);
  float* sbias = reinterpret_cast<float*>(smem + L.bias);   // [h][T][8 NT]
  for (int i = threadIdx.x; i < (int)((L.bias - L.zero) / 16); i += nthreads)
    reinterpret_cast<uint4*>(smem + L.zero)[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < h * T * 8 * NT; i += nthreads) {
    const int j = i % (8 * NT), hi = i / (8 * NT);
    sbias[i] = j < T ? pb[hi * T + j] : -INFINITY;
  }

  auto fetch = [&](int site, int stage) {
    float* dst = ring + stage * 3 * slab;
    const int per_row = F / 4;
    for (int i = threadIdx.x; i < 3 * T * per_row; i += nthreads) {
      const int t = i / (T * per_row), rem = i - t * T * per_row;
      const int r = rem / per_row, cc = rem - r * per_row;
      const float* src = t == 0 ? q : t == 1 ? k : v;
      mma::cp_async_16(dst + t * slab + r * rs + cc * 4, src + ((size_t)site * T + r) * F + cc * 4);
    }
    mma::cp_async_commit();
  };

  int site = blockIdx.x, it = 0;
  for (int i = 0; i < kTaTf32Stages - 1; ++i) {
    if (site + i * (int)gridDim.x < nsites) fetch(site + i * gridDim.x, i);
    else mma::cp_async_commit();
  }
  for (; site < nsites; ++it, site += gridDim.x) {
    const int stage = it % kTaTf32Stages;
    mma::cp_async_wait<kTaTf32Stages - 2>();
    __syncthreads();   // this site has landed; the readers of the stage refilled next are done
    const int ahead = site + (kTaTf32Stages - 1) * gridDim.x;
    if (ahead < nsites) fetch(ahead, (it + kTaTf32Stages - 1) % kTaTf32Stages);
    else mma::cp_async_commit();
    float* const Qs = ring + stage * 3 * slab + warp * D;
    const float *const Ks = Qs + slab, *const Vs = Qs + 2 * slab;

    float sp[MT][NT][4];
    ta_warp_softmax_tf32<D, NT, false>(Qs, Ks, nullptr, nullptr, zero,
                                       sbias + warp * T * 8 * NT, T, rs, lane, sp, sp, sp);
    ta_tf32_xa<D, NT>(Qs, Vs, zero, sp, T, rs, lane);   // o = P v, into q's slot
    __syncthreads();   // every warp's o is in the slot
    const float* st = ring + stage * 3 * slab;
    for (int i = threadIdx.x; i < T * (F / 4); i += nthreads) {
      const int r = i / (F / 4), cc = i - r * (F / 4);
      *reinterpret_cast<float4*>(o + ((size_t)site * T + r) * F + cc * 4) =
          *reinterpret_cast<const float4*>(st + r * rs + cc * 4);
    }
  }
}

// Calls fn(D, NT) (as std::integral_constant arguments) for the
// instantiated head width D and 8-column tiles NT = ceil(T / 8) of the
// tensor-core variants; cudaErrorInvalidValue for any other.
template <typename Fn>
cudaError_t with_ta_mma_instance(int d, int T, Fn&& fn) {
  using std::integral_constant;
  const int nt = (T + 7) / 8;
#define TA_MMA_INSTANCE(DD, NN) \
  if (d == DD && nt == NN) return fn(integral_constant<int, DD>(), integral_constant<int, NN>())
  TA_MMA_INSTANCE(32, 3);   // the UNet: T 20, d 32
  TA_MMA_INSTANCE(16, 1);
  TA_MMA_INSTANCE(16, 2);
  TA_MMA_INSTANCE(16, 3);
  TA_MMA_INSTANCE(16, 4);
  TA_MMA_INSTANCE(32, 1);
  TA_MMA_INSTANCE(32, 2);
  TA_MMA_INSTANCE(32, 4);
  TA_MMA_INSTANCE(64, 1);
  TA_MMA_INSTANCE(64, 2);
  TA_MMA_INSTANCE(64, 3);
  TA_MMA_INSTANCE(64, 4);
#undef TA_MMA_INSTANCE
  return cudaErrorInvalidValue;
}

// The tensor-core variants' codes, as the C entry points take them
// (ops/kernels.py: VARIANTS["ta_fwd"], VARIANTS["ta_bwd"]).
constexpr int kMma = 1, kTf32 = 2;

// Shared memory of a block of the forward's (FWD) or the backward's
// tensor-core variant V (kMma or kTf32).
template <bool FWD>
size_t ta_tc_smem(int V, int T, int h, int d) {
  if (V == kTf32) return FWD ? TaFwdTf32Layout(T, h, d).total : TaTf32Layout(T, h, d).total;
  return FWD ? TaFwdMmaLayout(T, h, d).total : TaMmaLayout(T, h, d).total;
}

template <bool FWD>
bool ta_tc_shape(int V, int nsites, int T, int h, int d) {
  return (V == kMma || V == kTf32) && nsites > 0 && T >= 1 && T <= 32 && h >= 1 &&
         h <= kTaMaxHeads && (d == 16 || d == 32 || d == 64) &&
         ta_tc_smem<FWD>(V, T, h, d) <= kMaxSmem;
}

// Calls fn(kernel) with the kernel of the forward's (FWD) or the backward's
// tensor-core variant V at head width D and NT column tiles.
template <bool FWD, int DD, int NN, typename Fn>
cudaError_t with_ta_tc_kernel(int V, Fn&& fn) {
  if constexpr (FWD)
    return V == kTf32 ? fn(ta_fwd_tf32_kernel<DD, NN>) : fn(ta_fwd_mma_kernel<DD, NN>);
  else
    return V == kTf32 ? fn(ta_bwd_tf32_kernel<DD, NN>) : fn(ta_bwd_mma_kernel<DD, NN>);
}

// The persistent grid of the forward's (FWD) or the backward's tensor-core
// variant V: as many blocks as the card's SMs hold at once, never more than
// sites; 0 on error.
template <bool FWD>
int ta_tc_blocks(int V, int nsites, int T, int h, int d) {
  if (!ta_tc_shape<FWD>(V, nsites, T, h, d)) return 0;
  const size_t smem = ta_tc_smem<FWD>(V, T, h, d);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  cudaError_t err = with_ta_mma_instance(d, T, [&](auto dd, auto nn) {
    return with_ta_tc_kernel<FWD, decltype(dd)::value, decltype(nn)::value>(V, [&](auto kern) {
      cudaError_t e = fno::allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * h, smem);
    });
  });
  if (err != cudaSuccess || sms * per_sm < 1) return 0;
  return nsites < sms * per_sm ? nsites : sms * per_sm;
}

// The backward's tensor-core variant V: bf16 tensors (kMma) or f32 (kTf32).
cudaError_t launch_bwd_tc(int V, const void* q, const void* k, const void* v, const void* pb,
                          const void* dout, void* dq, void* dk, void* dv, void* partial,
                          void* dpb, int nsites, int T, int h, int d, cudaStream_t stream) {
  for (const void* p : {q, k, v, dout, (const void*)dq, (const void*)dk, (const void*)dv})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int grid = ta_tc_blocks<false>(V, nsites, T, h, d);
  if (grid < 1) return cudaErrorInvalidValue;
  const size_t smem = ta_tc_smem<false>(V, T, h, d);
  cudaError_t err = with_ta_mma_instance(d, T, [&](auto dd, auto nn) {
    constexpr int DD = decltype(dd)::value, NN = decltype(nn)::value;
    if (V == kTf32)
      ta_bwd_tf32_kernel<DD, NN><<<grid, 32 * h, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(pb),
          static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
          static_cast<float*>(dv), static_cast<float*>(partial), nsites, T, h);
    else
      ta_bwd_mma_kernel<DD, NN><<<grid, 32 * h, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(pb), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(partial), nsites,
          T, h);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(dpb), grid,
                              h * T * T, stream);
}

// The forward's tensor-core variant V: bf16 tensors (kMma) or f32 (kTf32).
cudaError_t launch_fwd_tc(int V, const void* q, const void* k, const void* v, const void* pb,
                          void* o, int nsites, int T, int h, int d, cudaStream_t stream) {
  for (const void* p : {q, k, v, (const void*)o})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int grid = ta_tc_blocks<true>(V, nsites, T, h, d);
  if (grid < 1) return cudaErrorInvalidValue;
  const size_t smem = ta_tc_smem<true>(V, T, h, d);
  return with_ta_mma_instance(d, T, [&](auto dd, auto nn) {
    constexpr int DD = decltype(dd)::value, NN = decltype(nn)::value;
    if (V == kTf32)
      ta_fwd_tf32_kernel<DD, NN><<<grid, 32 * h, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(pb), static_cast<float*>(o),
          nsites, T, h);
    else
      ta_fwd_mma_kernel<DD, NN><<<grid, 32 * h, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const float*>(pb), static_cast<bf16*>(o), nsites, T, h);
    return cudaGetLastError();
  });
}

inline int round32(int n) { return (n + 31) / 32 * 32; }

// The tile: as many sites as fit kMaxThreads tasks and the smem budget.
template <typename Layout>
bool tile_shape(int nsites, int T, int h, int D, int es, size_t budget, TaShape* s) {
  const int tasks = h * T;
  if (nsites <= 0 || T <= 0 || tasks > kMaxThreads) return false;
  *s = TaShape{nsites, T, h, 1, T | 1};
  if (Layout(*s, h * D, es).total > kMaxSmem) return false;
  for (int ns = 2; ns * tasks <= kMaxThreads; ++ns) {
    TaShape t = *s;
    t.ns = ns;
    if (Layout(t, h * D, es).total > budget) break;
    *s = t;
  }
  return true;
}

int bwd_grid(const TaShape& s) {
  const int ntiles = (s.nsites + s.ns - 1) / s.ns;
  return ntiles < kBwdBlocks ? ntiles : kBwdBlocks;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* pb, void* o,
                       const TaShape& s, cudaStream_t stream) {
  const size_t smem = FwdLayout(s, s.h * D, sizeof(T)).total;
  auto kern = ta_fwd_kernel<T, D>;
  cudaError_t err = fno::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int grid = (s.nsites + s.ns - 1) / s.ns;
  kern<<<grid, round32(s.ns * s.h * s.T), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(pb), static_cast<T*>(o), s);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* pb,
                       const void* dout, void* dq, void* dk, void* dv, void* partial, void* dpb,
                       const TaShape& s, cudaStream_t stream) {
  const size_t smem = BwdLayout(s, s.h * D, sizeof(T)).total;
  auto kern = ta_bwd_kernel<T, D>;
  cudaError_t err = fno::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int grid = bwd_grid(s);
  kern<<<grid, round32(s.ns * s.h * s.T), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(pb), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(partial), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(dpb),
                              grid, s.h * s.T * s.T, stream);
}

bool fwd_shape(int nsites, int T, int h, int d, int dtype, TaShape* s) {
  return tile_shape<FwdLayout>(nsites, T, h, d, dtype == fno::kBF16 ? 2 : 4, kFwdSmem, s);
}

bool bwd_shape(int nsites, int T, int h, int d, int dtype, TaShape* s) {
  return tile_shape<BwdLayout>(nsites, T, h, d, dtype == fno::kBF16 ? 2 : 4, kBwdSmem, s);
}

}  // namespace

#define TA_DISPATCH_D(T, CALL) \
  switch (d) {                 \
    case 8:                    \
      return CALL(T, 8);       \
    case 16:                   \
      return CALL(T, 16);      \
    case 32:                   \
      return CALL(T, 32);      \
    case 64:                   \
      return CALL(T, 64);      \
    default:                   \
      return cudaErrorInvalidValue; \
  }

// Bytes of shared memory a block of ta_fwd's mma (tf32) variant takes.
extern "C" int ta_fwd_mma_smem_bytes(int T, int h, int d) {
  return (int)TaFwdMmaLayout(T, h, d).total;
}
extern "C" int ta_fwd_tf32_smem_bytes(int T, int h, int d) {
  return (int)TaFwdTf32Layout(T, h, d).total;
}

// variant: 0 fma, 1 mma (bf16), 2 tf32 (f32) (ops/kernels.py:
// VARIANTS["ta_fwd"]).
extern "C" int ta_fwd(const void* q, const void* k, const void* v, const void* pb, void* o,
                      int nsites, int T, int h, int d, int variant, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kMma || variant == kTf32) {
    if (dtype != (variant == kMma ? fno::kBF16 : fno::kF32)) return cudaErrorInvalidValue;
    return launch_fwd_tc(variant, q, k, v, pb, o, nsites, T, h, d, st);
  }
  TaShape s;
  if (variant != 0 || !fwd_shape(nsites, T, h, d, dtype, &s)) return cudaErrorInvalidValue;
#define TA_FWD(TT, DD) launch_fwd<TT, DD>(q, k, v, pb, o, s, st)
  if (dtype == fno::kF32) {
    TA_DISPATCH_D(float, TA_FWD)
  }
  TA_DISPATCH_D(__nv_bfloat16, TA_FWD)
#undef TA_FWD
}

// Bytes of shared memory a block of ta_bwd's mma (tf32) variant takes.
extern "C" int ta_bwd_mma_smem_bytes(int T, int h, int d) {
  return (int)TaMmaLayout(T, h, d).total;
}
extern "C" int ta_bwd_tf32_smem_bytes(int T, int h, int d) {
  return (int)TaTf32Layout(T, h, d).total;
}

// Number of [h, T, T] partials ta_bwd writes for variant 0 (fma), 1 (mma)
// or 2 (tf32; the tensor-core variants: one a block of the persistent
// grid); 0 for a shape or dtype it refuses.
extern "C" int ta_bwd_num_partials(int nsites, int T, int h, int d, int variant, int dtype) {
  if (variant == kMma || variant == kTf32)
    return dtype == (variant == kMma ? fno::kBF16 : fno::kF32)
               ? ta_tc_blocks<false>(variant, nsites, T, h, d)
               : 0;
  TaShape s;
  return variant == 0 && bwd_shape(nsites, T, h, d, dtype, &s) ? bwd_grid(s) : 0;
}

// variant: 0 fma, 1 mma (bf16), 2 tf32 (f32) (ops/kernels.py:
// VARIANTS["ta_bwd"]); partial holds ta_bwd_num_partials(...) [h, T, T]
// floats.
extern "C" int ta_bwd(const void* q, const void* k, const void* v, const void* pb,
                      const void* dout, void* dq, void* dk, void* dv, void* partial, void* dpb,
                      int nsites, int T, int h, int d, int variant, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kMma || variant == kTf32) {
    if (dtype != (variant == kMma ? fno::kBF16 : fno::kF32)) return cudaErrorInvalidValue;
    return launch_bwd_tc(variant, q, k, v, pb, dout, dq, dk, dv, partial, dpb, nsites, T, h, d,
                         st);
  }
  TaShape s;
  if (variant != 0 || !bwd_shape(nsites, T, h, d, dtype, &s)) return cudaErrorInvalidValue;
#define TA_BWD(TT, DD) launch_bwd<TT, DD>(q, k, v, pb, dout, dq, dk, dv, partial, dpb, s, st)
  if (dtype == fno::kF32) {
    TA_DISPATCH_D(float, TA_BWD)
  }
  TA_DISPATCH_D(__nv_bfloat16, TA_BWD)
#undef TA_BWD
}
