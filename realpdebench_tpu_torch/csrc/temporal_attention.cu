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
// Design: a block takes a tile of `ns` consecutive sites, whose q/k/v slabs
// (T*h*D contiguous elements a site) it stages in shared memory with 16-byte
// loads. A thread takes one (site, head, row i): q_i in registers, the
// row's T scores in a padded shared-memory row (odd stride: the threads of
// a warp, on consecutive rows, hit distinct banks), an exact softmax over
// them, and an f32 accumulator of D for o_i, written once. Threads of one
// (site, head) read the same k_j / v_j, so a warp's shared loads broadcast.
// The backward keeps P and dS rows of the tile in shared memory: phase A
// (thread = row i) writes P, dS and dq_i; phase B (thread = column j) sums
// dk_j and dv_j over i; phase C adds the tile's dS over its sites into a
// per-block f64 [h, T, T] accumulator. Blocks loop over tiles and each
// writes its accumulator as a partial; fno::reduce_partials adds the
// partials in a fixed order, so dpb repeats bit for bit. No atomics.
// Bound: at the UNet's level 0 (B 12, S 8192, T 20, h 4, D 32, bf16) the
// forward moves 2.0 GB (q, k, v read, o written: 0.60 ms at 3.35 TB/s) for
// 20 GFLOP, the backward 3.5 GB (1.05 ms) for 50 GFLOP: HBM bounds both on
// paper, but the products run as f32 FMAs on CUDA cores (0.3 / 0.75 ms at
// the 67 TFLOP/s FP32 peak), so FP32 issue is close behind. The tiny T x D
// tiles on tensor cores (mma.sync) are the next step.
#include "fno_common.cuh"

#include <math.h>

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

extern "C" int ta_fwd(const void* q, const void* k, const void* v, const void* pb, void* o,
                      int nsites, int T, int h, int d, int dtype, void* stream) {
  TaShape s;
  if (!fwd_shape(nsites, T, h, d, dtype, &s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TA_FWD(TT, DD) launch_fwd<TT, DD>(q, k, v, pb, o, s, st)
  if (dtype == fno::kF32) {
    TA_DISPATCH_D(float, TA_FWD)
  }
  TA_DISPATCH_D(__nv_bfloat16, TA_FWD)
#undef TA_FWD
}

// Number of [h, T, T] partials ta_bwd writes (0 for a shape it refuses).
extern "C" int ta_bwd_num_partials(int nsites, int T, int h, int d, int dtype) {
  TaShape s;
  return bwd_shape(nsites, T, h, d, dtype, &s) ? bwd_grid(s) : 0;
}

extern "C" int ta_bwd(const void* q, const void* k, const void* v, const void* pb,
                      const void* dout, void* dq, void* dk, void* dv, void* partial, void* dpb,
                      int nsites, int T, int h, int d, int dtype, void* stream) {
  TaShape s;
  if (!bwd_shape(nsites, T, h, d, dtype, &s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TA_BWD(TT, DD) launch_bwd<TT, DD>(q, k, v, pb, dout, dq, dk, dv, partial, dpb, s, st)
  if (dtype == fno::kF32) {
    TA_DISPATCH_D(float, TA_BWD)
  }
  TA_DISPATCH_D(__nv_bfloat16, TA_BWD)
#undef TA_BWD
}
