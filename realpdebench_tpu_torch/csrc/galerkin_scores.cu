// Galerkin scores: per (batch b, head h), with per-head affine LayerNorms,
//   S[b, h] = LN_K(k[b, :, h, :])^T . LN_V(v[b, :, h, :]) / N   ([D, D] f32)
//   k, v [B, N, h*D] (T = bf16 or f32: the q/k/v Dense's own token layout),
//   ks, kb, vs, vb [h, D] f32, S [B, h, D, D] f32.
//   LN(x) = (x - mean) / sqrt(var + eps) * scale + bias over the D features of
//   one (token, head), in f32, with the population variance.
//
// Replaces realpdebench_tpu/ops/pallas/galerkin.py::_scores_kernel. The TPU
// kernel runs one pallas_call per (b, h) and carries one [D, D] accumulator
// across a sequential grid over N; on the H100 the B*h = 64 pairs of the
// cylinder configuration would fill under half of the 132 SMs, so N is split
// into chunks across blocks too.
//
// Design: a block takes (chunk of N, group of up to 4 heads, b), 64 threads a
// head. It walks its chunk in tiles of 32 tokens. Phase 1: groups of D/4
// lanes read one (token, head) row of D features (consecutive groups read
// consecutive heads of a token, so a warp reads contiguous 512 B rows of the
// [B, N, h*D] layout), normalise it in f32 with shuffle reductions, and store
// it in shared memory. Phase 2: each thread owns a (D/8) x (D/8) tile of its
// head's [D, D] accumulator in registers and adds the tile's outer products
// (f32 FMAs: K rows broadcast, V columns read as conflict-free vectors).
// A token tile that runs past the chunk's end stops at the last token, so any
// N is taken. Each block writes its [heads, D, D] partial; the fixed-order
// f64 pass fno::reduce_partials adds the chunks and scales by 1/N: no atomics,
// the same bits on every run.
// Bound: at the cylinder width (B 16, N 163840, h 4, D 64, bf16) the kernel
// reads 2.7 GB (0.80 ms at 3.35 TB/s) for 86 GFLOP of products; run as FP32
// FMAs on the CUDA cores those take 1.3 ms at the 67 TFLOP/s peak, so FP32
// issue bounds this simple version, not HBM. Tensor-core products (mma.sync
// on bf16 operands of the normalised rows) and an asynchronous copy of the
// next tile under the current one's products are the next steps.
#include "fno_common.cuh"

#include <math.h>

namespace {

constexpr int kTile = 32;            // tokens a tile
constexpr int kHeadsPerBlock = 4;
constexpr int kThreadsPerHead = 64;  // an 8 x 8 grid of output tiles
constexpr int kMaxThreads = kHeadsPerBlock * kThreadsPerHead;
constexpr int kTargetBlocks = 528;   // 4 blocks per SM on 132 SMs: two waves of 2

// 4 consecutive elements at p (8-byte aligned for bf16, 16 for f32) as floats
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// Sum over the S aligned lanes of a row group (S a power of two <= 32).
template <int S>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// LayerNorm of one (token, head) row spread over S = D/4 lanes, 4 features a
// lane (x in, normalised out), with this lane's 4 scales and biases.
template <int D>
__device__ __forceinline__ void layer_norm4(float (&x)[4], const float (&s)[4],
                                            const float (&b)[4], float eps) {
  constexpr int S = D / 4;
  const float mean = group_sum<S>(x[0] + x[1] + x[2] + x[3]) * (1.0f / D);
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] -= mean;
    q = fmaf(x[e], x[e], q);
  }
  const float inv = 1.0f / sqrtf(group_sum<S>(q) * (1.0f / D) + eps);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = fmaf(x[e] * inv, s[e], b[e]);
}

// RT (= D/8) consecutive-or-strided floats of a thread's rows or columns:
// chunks of VW, chunk c at c*8*VW + t*VW, so the 8 threads along one axis
// read 8*VW contiguous floats per chunk.
template <int D>
struct Frag {
  static constexpr int RT = D / 8;
  static constexpr int VW = RT < 4 ? RT : 4;
  static constexpr int NV = RT / VW;
  __device__ static __forceinline__ int index(int t, int r) {
    return (r / VW) * 8 * VW + t * VW + r % VW;
  }
  __device__ static __forceinline__ void load(const float* row, int t, float (&f)[RT]) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float* p = row + c * 8 * VW + t * VW;
      if constexpr (VW == 4) {
        const float4 u = *reinterpret_cast<const float4*>(p);
        f[c * 4] = u.x;
        f[c * 4 + 1] = u.y;
        f[c * 4 + 2] = u.z;
        f[c * 4 + 3] = u.w;
      } else {
        const float2 u = *reinterpret_cast<const float2*>(p);
        f[c * 2] = u.x;
        f[c * 2 + 1] = u.y;
      }
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gk_scores_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ ks, const float* __restrict__ kb,
                     const float* __restrict__ vs, const float* __restrict__ vb,
                     float* __restrict__ partial, int B, int N, int h, int chunk, float eps) {
  constexpr int S = D / 4;
  constexpr int RT = D / 8;
  using Fr = Frag<D>;
  extern __shared__ __align__(16) float smem[];
  const int h0 = blockIdx.y * kHeadsPerBlock;
  const int hb = min(kHeadsPerBlock, h - h0);  // heads of this block
  const int b = blockIdx.z;
  const int W = hb * D;                        // floats in a shared row
  float* skn = smem;
  float* svn = smem + kTile * W;
  const int F = h * D;
  const int n0 = blockIdx.x * chunk;
  const int n1 = min(N, n0 + chunk);

  // phase 1: rows r = token * hb + head, S lanes a row, on the first hb*64
  // threads (the last head group of h % 4 heads leaves the rest idle): the
  // rows a pass covers are a multiple of hb, so a thread keeps one head
  const int tid = threadIdx.x;
  const int lane = tid % S;
  const int active = hb * kThreadsPerHead;
  const int rows_per_pass = active / S;
  const int my_head = (tid / S) % hb;
  const int c0 = (h0 + my_head) * D + lane * 4;
  float ksr[4], kbr[4], vsr[4], vbr[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ksr[e] = ks[c0 + e];
    kbr[e] = kb[c0 + e];
    vsr[e] = vs[c0 + e];
    vbr[e] = vb[c0 + e];
  }

  // phase 2: thread (head hh, row tile ti, column tile tj)
  const int hh = tid / kThreadsPerHead;
  const int ti = (tid % kThreadsPerHead) / 8;
  const int tj = tid % 8;
  float acc[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;

  for (int t0 = n0; t0 < n1; t0 += kTile) {
    const int nt = min(kTile, n1 - t0);
    __syncthreads();  // the previous tile's readers are done
    // every active thread runs kTile*S/64 passes (the shuffles need whole
    // warps; active is a multiple of 32)
    for (int r = tid / S; tid < active && r < kTile * hb; r += rows_per_pass) {
      const int tok = r / hb;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      const bool valid = tok < nt;
      if (valid) {
        const size_t off = ((size_t)b * N + t0 + tok) * F + c0;
        load4(k + off, kx);
        load4(v + off, vx);
      }
      layer_norm4<D>(kx, ksr, kbr, eps);
      layer_norm4<D>(vx, vsr, vbr, eps);
      const int so = tok * W + my_head * D + lane * 4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(skn + so) = valid ? make_float4(kx[0], kx[1], kx[2], kx[3]) : zero;
      *reinterpret_cast<float4*>(svn + so) = valid ? make_float4(vx[0], vx[1], vx[2], vx[3]) : zero;
    }
    __syncthreads();
    if (hh < hb) {
      const float* kr = skn + hh * D;
      const float* vr = svn + hh * D;
#pragma unroll 2
      for (int t = 0; t < nt; ++t) {
        float a[RT], c[RT];
        Fr::load(kr + t * W, ti, a);
        Fr::load(vr + t * W, tj, c);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
      }
    }
  }

  if (hh < hb) {
    float* out = partial + (((size_t)blockIdx.x * B + b) * h + h0 + hh) * D * D;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) out[Fr::index(ti, i) * D + Fr::index(tj, j)] = acc[i][j];
  }
}

// The chunking of N: as many chunks as bring B * groups * chunks near
// kTargetBlocks, whole tiles a chunk. Returns the number of chunks (the
// partials) and sets *chunk to a chunk's length in tokens.
int plan(int B, int N, int h, int* chunk) {
  const int groups = (h + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const int tiles = (N + kTile - 1) / kTile;
  int p = (kTargetBlocks + B * groups - 1) / (B * groups);
  p = p < tiles ? p : tiles;
  p = p < 1 ? 1 : p;
  *chunk = (tiles + p - 1) / p * kTile;
  return (N + *chunk - 1) / *chunk;
}

bool valid_shape(int B, int N, int h, int d) {
  return B > 0 && N > 0 && h > 0 && (d == 16 || d == 32 || d == 64) && B <= 65535;
}

template <typename T, int D>
cudaError_t launch(const void* k, const void* v, const void* ks, const void* kb, const void* vs,
                   const void* vb, void* partial, void* out, int B, int N, int h, float eps,
                   cudaStream_t stream) {
  int chunk;
  const int nparts = plan(B, N, h, &chunk);
  const int hb = h < kHeadsPerBlock ? h : kHeadsPerBlock;
  const size_t smem = 2 * (size_t)kTile * hb * D * sizeof(float);
  auto kern = gk_scores_kernel<T, D>;
  cudaError_t err = fno::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nparts, (h + kHeadsPerBlock - 1) / kHeadsPerBlock, B);
  kern<<<grid, hb * kThreadsPerHead, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(kb), static_cast<const float*>(vs),
      static_cast<const float*>(vb), static_cast<float*>(partial), B, N, h, chunk, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(out),
                              nparts, B * h * D * D, stream, 1.0 / (double)N);
}

}  // namespace

// Number of [B, h, d, d] partials gk_scores writes (0 for a shape it refuses).
extern "C" int gk_scores_num_partials(int B, int N, int h, int d) {
  int chunk;
  return valid_shape(B, N, h, d) ? plan(B, N, h, &chunk) : 0;
}

extern "C" int gk_scores(const void* k, const void* v, const void* ks, const void* kb,
                         const void* vs, const void* vb, void* partial, void* out, int B, int N,
                         int h, int d, float eps, int dtype, void* stream) {
  if (!valid_shape(B, N, h, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GK_CALL(TT, DD) launch<TT, DD>(k, v, ks, kb, vs, vb, partial, out, B, N, h, eps, st)
#define GK_DISPATCH_D(TT)           \
  switch (d) {                      \
    case 16:                        \
      return GK_CALL(TT, 16);       \
    case 32:                        \
      return GK_CALL(TT, 32);       \
    default:                        \
      return GK_CALL(TT, 64);       \
  }
  if (dtype == fno::kF32) {
    GK_DISPATCH_D(float)
  }
  GK_DISPATCH_D(__nv_bfloat16)
#undef GK_DISPATCH_D
#undef GK_CALL
}
