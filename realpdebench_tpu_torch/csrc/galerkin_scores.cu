// Galerkin scores: per (batch b, head h), with per-head affine LayerNorms,
//   S[b, h] = LN_K(k[b, :, h, :])^T . LN_V(v[b, :, h, :]) / n_total   ([D, D] f32)
//   n_total is N, or on a token shard (sequence parallelism) the global token
//   count, so that the shards' S summed over the mp group are the whole's.
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
// Two variants, chosen before the launch by ops/kernels.py::gk_scores_variant
// (VARIANTS["gk_scores"]).
//
// `fma` (gk_scores_kernel): a block takes (chunk of N, group of up to 4
// heads, b), 64 threads a head. It walks its chunk in tiles of 32 tokens.
// Phase 1: groups of D/4 lanes read one (token, head) row of D features
// (consecutive groups read consecutive heads of a token, so a warp reads
// contiguous 512 B rows of the [B, N, h*D] layout), normalise it in f32 with
// shuffle reductions, and store it in shared memory. Phase 2: each thread
// owns a (D/8) x (D/8) tile of its head's [D, D] accumulator in registers
// and adds the tile's outer products (f32 FMAs: K rows broadcast, V columns
// read as conflict-free vectors). A token tile that runs past the chunk's
// end stops at the last token, so any N is taken. Each block writes its
// [heads, D, D] partial; the fixed-order f64 pass fno::reduce_partials adds
// the chunks and scales by 1/N: no atomics, the same bits on every run.
// Bound: at the cylinder width (B 16, N 163840, h 4, D 64, bf16) the kernel
// reads 2.7 GB (0.80 ms at 3.35 TB/s) for 86 GFLOP of products; run as FP32
// FMAs on the CUDA cores those take 1.3 ms at the 67 TFLOP/s peak, so FP32
// issue bounds this variant, not HBM.
//
// `mma` (gk_scores_mma_kernel; d 16/32/64, bf16 and f32 inputs, 16-byte
// aligned k and v): the products on the tensor cores. A block takes (head,
// chunk of N, b) with D/16 warps; the grid fills the card's SMs once over
// its B h blocks of (head, b). Its token rows (D contiguous features of one
// head) come by 16-byte cp.async into a two-stage ring of 32-token tiles.
// The LayerNorm runs per (token, head) in f32 with shuffle reductions, as in
// `fma` (the reciprocal square root by rsqrtf), and the normalised rows of K
// and V are staged in shared memory as bf16 hi + lo pairs
// (mma.cuh::split_pack): the rows are f32 (the f32 affine promotes them, as
// in the Pallas kernel) and the scores are held to 1e-4 of max|ref|, which
// one bf16 rounding (2^-9) would not meet. Warp w runs rows 16w..16w+15 of
// the head's LN(K)^T LN(V) on mma.sync as hi.hi + hi.lo + lo.hi (the tokens
// are the k dimension, both operands read by ldmatrix.trans) into f32
// accumulators, which go into the thread's f32 sums every kGkFlush tiles (an
// MMA's accumulation truncates; K3B's sums read 6.4e-6 of sum |terms|
// flushed so against 4.5e-5-7.1e-5 without). The staged rows are
// double-buffered: one barrier a tile, after which a tile's LayerNorm and
// the previous tile's products run. Each block writes its [D, D] partial,
// and fno::reduce_partials adds them as for `fma`. Work: 2.7 GB, ~258
// GFLOP of MMAs issued (three products) and ~13 G f32 operations of
// LayerNorm. What bounds it (tools/torch_gk_probe.py at the cylinder width):
// not HBM (the reads alone take about 1.1x the 0.80 ms bound) but the
// LayerNorm's issue (~20 SASS instructions an element, alone about 1.7x the
// bound) and shared memory, which every element crosses some 22 bytes at a
// time (raw row in and out, hi + lo rows in, their ldmatrix reads by every
// warp that needs them).
#include "fno_common.cuh"
#include "mma.cuh"

#include <math.h>

#include <type_traits>

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
                   const void* vb, void* partial, void* out, int B, int N, int n_total, int h,
                   float eps, cudaStream_t stream) {
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
                              nparts, B * h * D * D, stream, 1.0 / (double)n_total);
}

// ---------------------------------------------------------------------------
// The tensor-core variant
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kGkTile = 32;     // tokens a tile: two k-steps of mma.sync
constexpr int kGkStages = 2;    // tiles in a block's ring of raw rows
constexpr int kGkFlush = 32;    // tiles an MMA accumulator takes before the f32 sums
constexpr int kGkRowPad = 8;    // padding of a staged row, in bf16 (bank spread)

// Shared memory of a block, in bytes from the base (host and device agree;
// ops/kernels.py::gk_scores_mma_smem_bytes); es: bytes of an input element.
struct GkMmaLayout {
  size_t ring, affine, rows, total;
  __host__ __device__ GkMmaLayout(int D, int es) {
    ring = 0;                                                  // [kGkStages][k, v][kGkTile][D]
    affine = ring + (size_t)kGkStages * 2 * kGkTile * D * es;  // [ks, kb, vs, vb][D] f32
    rows = affine + 4 * (size_t)D * 4;  // [2][k hi, k lo, v hi, v lo][kGkTile][D + kGkRowPad] bf16
    total = rows + 2 * 4 * (size_t)kGkTile * (D + kGkRowPad) * 2;
  }
};

// 8 consecutive elements at p (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  load4(p, f);
  load4(p + 4, f + 4);
}
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 x = mma::unpack_bf16(w[t]);
    f[2 * t] = x.x;
    f[2 * t + 1] = x.y;
  }
}

// D/16 warps a block (2 D threads), 16 warps an SM at 128 registers. Tile
// t's raw rows land in ring stage t % kGkStages; its
// normalised rows go to rows buffer t % 2. One barrier a tile: after it,
// the block normalises tile t + 1 and runs the products of tile t, which
// the previous interval normalised (the other order ran no faster:
// tools/torch_gk_probe.py).
template <typename T, int D>
__global__ void __launch_bounds__(2 * D, 512 / (2 * D))
    gk_scores_mma_kernel(const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ ks, const float* __restrict__ kb,
                         const float* __restrict__ vs, const float* __restrict__ vb,
                         float* __restrict__ partial, int B, int N, int h, int chunk, float eps) {
  constexpr int NTH = 2 * D;              // threads: D/16 warps
  constexpr int NP = D / 16;              // 16-column pairs of output tiles
  constexpr int L = D / 8;                // lanes a row of the LayerNorm, 8 features a lane
  constexpr int RPP = NTH / L;            // rows a pass of the LayerNorm (16)
  constexpr int RS = D + kGkRowPad;       // stride of a staged row
  constexpr int VEC = 16 / sizeof(T);     // elements a 16-byte copy
  static_assert(kGkTile % RPP == 0, "a pass takes rows of one of k and v");
  extern __shared__ __align__(16) unsigned char mma_smem[];   // gk_scores_kernel's is float
  const GkMmaLayout lay(D, sizeof(T));
  T* ring = reinterpret_cast<T*>(mma_smem + lay.ring);
  float* aff = reinterpret_cast<float*>(mma_smem + lay.affine);
  bf16* rows = reinterpret_cast<bf16*>(mma_smem + lay.rows);
  const int hh = blockIdx.x, b = blockIdx.z;
  const int F = h * D;
  const int n0 = blockIdx.y * chunk, n1 = min(N, n0 + chunk);
  const int ntiles = (n1 - n0 + kGkTile - 1) / kGkTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q4 = lane & 3;
  for (int i = tid; i < D; i += NTH) {
    aff[i] = ks[hh * D + i];
    aff[D + i] = kb[hh * D + i];
    aff[2 * D + i] = vs[hh * D + i];
    aff[3 * D + i] = vb[hh * D + i];
  }

  // tile t's token rows of k and v (tokens past n1 are not read); an empty
  // group past the last tile
  auto fetch = [&](int t) {
    if (t < ntiles) {
      T* dst = ring + (t % kGkStages) * 2 * kGkTile * D;
      const int tok0 = n0 + t * kGkTile;
      constexpr int per_row = D / VEC;
      for (int i = tid; i < 2 * kGkTile * per_row; i += NTH) {
        const int r = i / per_row, cc = i - r * per_row;   // r: [k, v][token]
        const int tok = tok0 + (r % kGkTile);
        if (tok < n1)
          mma::cp_async_16(dst + r * D + cc * VEC,
                           (r < kGkTile ? k : v) + ((size_t)b * N + tok) * F + hh * D + cc * VEC);
      }
    }
    mma::cp_async_commit();
  };

  // the LayerNorm of tile t: rows [k, v][token], pass p taking rows
  // p RPP + tid / L, L lanes a row, each row's normalised f32 values split
  // into bf16 hi + lo in rows buffer t % 2; without FULL, the rows past n1
  // are staged as zeros
  const int rr = tid / L, c8 = (tid % L) * 8;
  auto normalise = [&](int t, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const T* src = ring + (t % kGkStages) * 2 * kGkTile * D + rr * D + c8;
    bf16* dst = rows + (t % 2) * 4 * kGkTile * RS + rr * RS + c8;
    const int tok0 = n0 + t * kGkTile + rr;
#pragma unroll
    for (int pass = 0; pass < 2 * kGkTile / RPP; ++pass) {
      const int which = pass * RPP / kGkTile, tok = pass * RPP % kGkTile;   // fixed at compile time
      const bool valid = FULL || tok0 + tok < n1;
      float x[8];
      load8(src + pass * RPP * D, x);
      float s1 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!FULL) x[e] = valid ? x[e] : 0.f;
        s1 += x[e];
      }
      const float mean = group_sum<L>(s1) * (1.0f / D);
      float s2 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] -= mean;
        s2 = fmaf(x[e], x[e], s2);
      }
      const float inv = rsqrtf(group_sum<L>(s2) * (1.0f / D) + eps);
      const float* sc = aff + 2 * which * D + c8;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float y0 = fmaf(x[e] * inv, sc[e], sc[D + e]);
        float y1 = fmaf(x[e + 1] * inv, sc[e + 1], sc[D + e + 1]);
        if (!FULL) {
          y0 = valid ? y0 : 0.f;
          y1 = valid ? y1 : 0.f;
        }
        mma::split_pack(y0, y1, hi[e / 2], lo[e / 2]);
      }
      bf16* out = dst + (2 * which * kGkTile + tok) * RS;
      *reinterpret_cast<uint4*>(out) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(out + kGkTile * RS) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };
  auto normalise_tile = [&](int t) {
    if (n0 + (t + 1) * kGkTile <= n1) normalise(t, std::true_type());
    else normalise(t, std::false_type());
  };

  // rows 16 warp.. of LN(K)^T LN(V) over tile t (rows buffer t % 2):
  // hi.hi + hi.lo + lo.hi, tokens the k dimension
  float acc[2 * NP][4] = {}, sum[2 * NP][4] = {};
  auto products = [&](int t) {
    const bf16* khi = rows + (t % 2) * 4 * kGkTile * RS;
    const bf16* klo = khi + kGkTile * RS;
    const bf16* vhi = klo + kGkTile * RS;
    const bf16* vlo = vhi + kGkTile * RS;
#pragma unroll
    for (int ks16 = 0; ks16 < kGkTile / 16; ++ks16) {
      int kr, m;
      mma::at_frag_row(lane, 16 * ks16, 16 * warp, kr, m);
      uint32_t ahi[4], alo[4];
      mma::ldmatrix_x4_trans(ahi, mma::smem_addr(khi + kr * RS + m));
      mma::ldmatrix_x4_trans(alo, mma::smem_addr(klo + kr * RS + m));
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        int br, n;
        mma::b_frag_row(lane, 16 * ks16, 16 * np, br, n);
        uint32_t bhi[4], blo[4];
        mma::ldmatrix_x4_trans(bhi, mma::smem_addr(vhi + br * RS + n));
        mma::ldmatrix_x4_trans(blo, mma::smem_addr(vlo + br * RS + n));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float (&c)[4] = acc[2 * np + hf];
          mma::mma_bf16(c, ahi, bhi[2 * hf], bhi[2 * hf + 1]);
          mma::mma_bf16(c, ahi, blo[2 * hf], blo[2 * hf + 1]);
          mma::mma_bf16(c, alo, bhi[2 * hf], bhi[2 * hf + 1]);
        }
      }
    }
    if ((t + 1) % kGkFlush == 0 || t + 1 == ntiles) {
#pragma unroll
      for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[nt][e] += acc[nt][e];
          acc[nt][e] = 0.f;
        }
    }
  };

  // the ring: tiles 0 .. kGkStages - 1 in flight, a group each
  for (int i = 0; i < kGkStages; ++i) fetch(i);
  mma::cp_async_wait<kGkStages - 1>();
  __syncthreads();   // tile 0 has landed; the affine is in place
  normalise_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    mma::cp_async_wait<kGkStages - 2>();
    __syncthreads();   // tile t + 1 has landed and tile t's rows are staged; the products of
                       // t - 1 (rows buffer (t + 1) % 2) and the LayerNorm of t (its stage) are done
    fetch(t + kGkStages);
    if (t + 1 < ntiles) normalise_tile(t + 1);
    products(t);
  }

  // this block's [D, D] partial: row i = 16 warp + gq (+8), column 8 nt + 2 q4
  float* out = partial + (((size_t)blockIdx.y * B + b) * h + hh) * D * D;
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(out + (16 * warp + gq + 8 * hf) * D + 8 * nt + 2 * q4) =
          make_float2(sum[nt][2 * hf], sum[nt][2 * hf + 1]);
}

// Calls fn(kernel) with the tensor-core variant's instantiation for input
// type T and head width d.
template <typename T, typename Fn>
cudaError_t with_gk_mma_kernel(int d, Fn&& fn) {
  switch (d) {
    case 16:
      return fn(gk_scores_mma_kernel<T, 16>);
    case 32:
      return fn(gk_scores_mma_kernel<T, 32>);
    case 64:
      return fn(gk_scores_mma_kernel<T, 64>);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core variant's chunking of N: as many chunks as fill the card's
// SMs once over the B h blocks of (head, b) (at least one), whole tiles a
// chunk. Returns the number of chunks (the partials; 0 on error) and sets
// *chunk to a chunk's length in tokens.
template <typename T>
int plan_mma(int B, int N, int h, int d, int* chunk) {
  const size_t smem = GkMmaLayout(d, sizeof(T)).total;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  cudaError_t err = with_gk_mma_kernel<T>(d, [&](auto kern) {
    cudaError_t e = fno::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 2 * d, smem);
  });
  if (err != cudaSuccess || per_sm < 1) return 0;
  const int tiles = (N + kGkTile - 1) / kGkTile;
  int p = sms * per_sm / (B * h);
  p = p < 1 ? 1 : p > tiles ? tiles : p;
  *chunk = (tiles + p - 1) / p * kGkTile;
  return (N + *chunk - 1) / *chunk;
}

template <typename T>
cudaError_t launch_mma(const void* k, const void* v, const void* ks, const void* kb,
                       const void* vs, const void* vb, void* partial, void* out, int B, int N,
                       int n_total, int h, int d, float eps, cudaStream_t stream) {
  if ((uintptr_t)k % 16 || (uintptr_t)v % 16) return cudaErrorMisalignedAddress;
  int chunk;
  const int nparts = plan_mma<T>(B, N, h, d, &chunk);
  if (nparts < 1) return cudaErrorInvalidValue;
  const size_t smem = GkMmaLayout(d, sizeof(T)).total;
  const dim3 grid(h, nparts, B);
  cudaError_t err = with_gk_mma_kernel<T>(d, [&](auto kern) {
    kern<<<grid, 2 * d, smem, stream>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(kb), static_cast<const float*>(vs),
        static_cast<const float*>(vb), static_cast<float*>(partial), B, N, h, chunk, eps);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(out),
                              nparts, B * h * d * d, stream, 1.0 / (double)n_total);
}

}  // namespace

// Bytes of shared memory a block of gk_scores's mma variant takes.
extern "C" int gk_scores_mma_smem_bytes(int d, int dtype) {
  return (int)GkMmaLayout(d, dtype == fno::kF32 ? 4 : 2).total;
}

// Number of [B, h, d, d] partials gk_scores writes for variant 0 (fma) or 1
// (mma: one a chunk of its grid, sized to this card); 0 for a shape it refuses.
extern "C" int gk_scores_num_partials(int B, int N, int h, int d, int variant, int dtype) {
  int chunk;
  if (!valid_shape(B, N, h, d)) return 0;
  if (variant == 1)
    return dtype == fno::kF32 ? plan_mma<float>(B, N, h, d, &chunk)
                              : plan_mma<bf16>(B, N, h, d, &chunk);
  return variant == 0 ? plan(B, N, h, &chunk) : 0;
}

// variant: 0 fma, 1 mma (ops/kernels.py: VARIANTS["gk_scores"]); partial
// holds gk_scores_num_partials(...) [B, h, d, d] floats; n_total >= N is the
// divisor (N, or the global token count of a token shard).
extern "C" int gk_scores(const void* k, const void* v, const void* ks, const void* kb,
                         const void* vs, const void* vb, void* partial, void* out, int B, int N,
                         int n_total, int h, int d, float eps, int variant, int dtype,
                         void* stream) {
  if (!valid_shape(B, N, h, d) || n_total < N) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return dtype == fno::kF32
               ? launch_mma<float>(k, v, ks, kb, vs, vb, partial, out, B, N, n_total, h, d, eps,
                                   st)
               : launch_mma<bf16>(k, v, ks, kb, vs, vb, partial, out, B, N, n_total, h, d, eps,
                                  st);
  if (variant != 0) return cudaErrorInvalidValue;
#define GK_CALL(TT, DD) \
  launch<TT, DD>(k, v, ks, kb, vs, vb, partial, out, B, N, n_total, h, eps, st)
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
