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
//   partial [fno_k12b_partial_floats] (f32) scratch
//   out [C*C + 3C] (f32): dWp (row c, column d), then da, db, dbp (fma);
//       dWp, dbp, da, db (mma, tf32)
//
// What bounds it on an H100: bytes. At training width (BT 832, Hp 70, Wp 134,
// C 64) a launch moves 4.08 GB (1.22 ms at 3.35 TB/s) and needs 171 GFLOP
// (the pointwise product 64, dWp 64, the inverse W 32, the inverse H 11):
// 0.17 ms on the tensor cores, 2.6 ms at the FP32 peak. The first version,
// on FP32 FMAs with both operands from shared memory, ran at 6% of the bound.
//
// Three variants, chosen from dtype, shape and alignment before the launch
// (ops/kernels.py::k12b_variant):
//
//  * mma (bf16; C in {32, 64, 128}, m3 in {8, 16}, 2*m2 <= 32, Wp <= 256 at C
//    <= 64 and <= 144 at C 128, 16-byte aligned x, s, ds, dy): two kernels
//    on mma.sync m16n8k16 (mma.cuh), f32 accumulators, every operand of
//    every product a bf16 hi + lo pair (three MMAs a product). dx feeds
//    da and db, and dWp, dbp are sums over 7.8 M positions held to 1e-4 of
//    their terms; one bf16 rounding of Wp, of a DFT table, of z (made from x
//    on the bf16 grid) or of ds_eff is the same error at every position and
//    lands in them, as it did in K2's statistics.
//      - The dz pass (K2's shape on the adjoint factors): a block takes
//        dz_rows(C) rows of H of one bt (5 at C 64), a warp the 16 columns
//        w0.. of each. dX for the block's rows first, as K2's inverse H:
//        dX = AH (16 x 2*2m2) . dy, dy's 16-channel pieces through per-warp
//        cp.async rings. Then per row one accumulator of depth 2*m3 + C:
//        dz = [EWr | EWi] (16 x 2*m3, fragments in registers) . dX_h +
//        ds_eff (16 x C) . Wp^T (C x C, in shared memory), ds_eff made on the
//        A fragment from 4-byte loads of ds and s (a lane's pairs fill
//        whole 32-byte sectors); du = dz * act'(a*x + b), dx = du * a and the
//        sums da, db from the f32 accumulators.
//      - The dWp pass: a block takes a fixed range of positions (at most 512
//        blocks), in tiles of 64 positions staged by cp.async, two stages;
//        the block makes each tile's ds_eff once, hi and lo, into shared
//        memory (and its dbp share); warp v owns rows 16v.. of dWp and every
//        column: z^T as A fragments by ldmatrix.trans of the x tile, the
//        activation on the fragment; ds_eff as B fragments of its tiles. x, s and ds are read a second time here (about 0.9 ms
//        of the 4.08 GB at C 64): the dz pass wants positions spread over
//        warps and a full row of channels per warp, dWp wants channels
//        spread over warps and positions along K, and both sets of tiles,
//        hi and lo, do not fit one block's shared memory at C 128.
//  * tf32 (f32 tensors; the mma variant's widths, W modes, H modes, warps and
//    alignment): the mma variant's two kernels with every product as 3xTF32
//    (mma.cuh: each f32 operand a tf32 hi + lo pair, hi.hi + hi.lo + lo.hi
//    on mma.sync m16n8k8, f32 accumulators; 22 bits a product where a bf16
//    pair of the same operands carries 16). Every f32 operand is stored
//    once in shared memory and split in registers on the fragment. The
//    exact GELU and its derivative take fno::erf_fast (A&S 7.1.26, |error|
//    <= 3e-7, the size of 3xTF32's own error), as in the mma variant; the
//    fma variant keeps erff.
//      - The dz pass keeps the mma variant's block plan. wp is staged as it
//        is, [c][d], the [n][k] layout of the pointwise product's B operand
//        (fragments by ldmatrix), as a tf32 hi + lo pair split once a
//        block, after the H stage, in the memory the dy rings leave, with
//        the 8 channels d of each k-step in the order 0 2 4 6 1 3 5 7: A
//        and B take the same order of k, so a lane's ds_eff pair of
//        channels (a0, a2) is one 8-byte load of ds and of s from global
//        memory. dX is made by fno_tf32.cuh's h_stage as [hl][c][k] in
//        f32 and split on the fragment; the DFT tables are f32 from the
//        host (ops/fno_layer.py::_k12b_tf32_tables). At C 64 the block
//        takes 85 KB: two blocks (18 warps) an SM, 96 registers a thread;
//        da and db are fno_tf32.cuh's ColumnSums. ptxas (-Xptxas -v,
//        sm_90a): 28 bytes of spill stores at <64, 2, 9, 2>, none at the
//        other instantiations (114-168 registers).
//      - The dWp pass: tiles of 32 positions of x, s and ds by cp.async (two
//        stages, rows of C + 8 floats); ds_eff made once a tile by the block
//        into tf32 hi and lo tiles (and dbp); warp v owns 16 rows of dWp.
//        Neither operand can come by ldmatrix (both are [k][n] tiles), so
//        both come by 8-byte shared loads: the rows of the warp's A
//        fragment are taken in the order c = 16v + 2g (row g), 16v + 2g + 1
//        (row g + 8), and each pair of 8-column B tiles in the order
//        d = 16u + 2g (tile 2u), 16u + 2g + 1 (tile 2u + 1); the rows of C +
//        8 floats put a half-warp's 8-byte loads on 32 banks, and the sums
//        leave as 16-byte stores in the natural order. x, s and ds are read
//        a second time here (1.8 ms of the bytes at the training width).
//        ptxas: 128 registers at <64>, 200 at <128>, no spills.
//      - What bounds it: the dz pass's latency at 18 warps an SM and 96
//        registers a thread (tools/torch_tf32_probe.py: one block an SM is
//        slower, an L2 prefetch of the next row slower still, its loads of
//        ds and s a sixth of its time), and the dWp pass's second read of
//        x, s and ds.
//  * fma (f32 tensors, other shapes; C dividing 256, up to 128): K2's shape,
//    run on the adjoint factors, with the accumulators added. A block takes
//    one bt image and 1/kSplit of its rows; for each row h it forms dX[h] =
//    the adjoint H DFT of dy (in shared memory) and, kWC columns of W at a
//    time, stages z and ds_eff, then thread (d, column group) produces kWQ
//    columns of dz for channel d, finishes dx there and sums da, db, dbp for
//    d in registers; a second sweep of the staged columns adds z^T ds_eff
//    into the thread's C*C/256 dWp entries (registers). Exact f32.
// No atomics in any: each block writes its partial, and
// fno::reduce_partials adds the partials in a fixed order, so a step is
// deterministic.
#include <cstdint>
#include <initializer_list>

#include "fno_common.cuh"
#include "fno_tf32.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;  // C must divide it
constexpr int kWQ = 4;         // dz columns per thread and pass
constexpr int kSplit = 2;      // blocks per bt image (row ranges)
constexpr int kWC = 32;        // columns of W a row stages at a time

// MAXC: the widest C the instantiation takes; a thread holds MAXC*MAXC /
// kThreads dWp entries in registers (16 at 64, 64 at 128).
template <typename T, int MAXC>
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
  float* sz = sdx_i + m3 * C;         // [kWC][C]: z of the current columns
  float* sd = sz + kWC * C;           // [kWC][C]: ds_eff of the current columns
  float* sa = sd + kWC * C;           // [C] each: a, b, ds1, 2*ds2
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
  constexpr int kNW = MAXC * MAXC / kThreads;
  float acc_w[kNW];  // dWp[wq + ncg*k, d]
#pragma unroll
  for (int k = 0; k < kNW; ++k) acc_w[k] = 0.f;

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
    for (int wc0 = 0; wc0 < Wp; wc0 += kWC) {
      const int ncol = min(kWC, Wp - wc0);
      __syncthreads();  // dX is staged; the previous columns are consumed
      for (int i = tid; i < ncol * C; i += kThreads) {
        const int c = i % C;
        const size_t at = row + (size_t)wc0 * C + i;
        sz[i] = fno::affine_act(fno::to_f32(x[at]), sa[c], sb[c], act);
        sd[i] = fno::to_f32(ds[at]) + s1[c] + s2[c] * fno::to_f32(s[at]);
      }
      __syncthreads();

      // dz for kWQ columns of channel d, then dx and the per-channel sums
      for (int w0 = wc0 + wq * kWQ; w0 < wc0 + ncol; w0 += nwq * kWQ) {
        float acc[kWQ];
        int wc[kWQ];
#pragma unroll
        for (int q = 0; q < kWQ; ++q) {
          acc[q] = 0.f;
          wc[q] = min(w0 + q, wc0 + ncol - 1);  // the ragged edge computes a duplicate, never stored
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
          for (int q = 0; q < kWQ; ++q) acc[q] = fmaf(sd[(wc[q] - wc0) * C + c], wv, acc[q]);
        }
#pragma unroll
        for (int q = 0; q < kWQ; ++q) {
          if (w0 + q < wc0 + ncol) {
            const size_t at = row + (size_t)(w0 + q) * C + d;
            const float xv = fno::to_f32(x[at]);
            const float du = acc[q] * fno::act_grad(fmaf(sa[d], xv, sb[d]), act);
            dx[at] = fno::from_f32<T>(du * sa[d]);
            da = fmaf(du, xv, da);
            db += du;
            dbp += sd[(w0 + q - wc0) * C + d];
          }
        }
      }

      // dWp[c, d] += sum over the columns of z[w, c] * ds_eff[w, d]
      if (wq < ncg) {
        for (int w = 0; w < ncol; ++w) {
          const float dv = sd[w * C + d];
#pragma unroll
          for (int k = 0; k < kNW; ++k) {
            const int c = wq + ncg * k;
            if (c < C) acc_w[k] = fmaf(sz[w * C + c], dv, acc_w[k]);
          }
        }
      }
    }
  }

  const int n = C * C + 3 * C;
  float* pb = partial + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * n;
  if (wq < ncg) {
#pragma unroll
    for (int k = 0; k < kNW; ++k) {
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

template <typename T, int MAXC>
cudaError_t launch_k12b_as(const void* x, const void* a, const void* b, const void* wp,
                           const void* s, const void* ds, const void* ds1, const void* ds2,
                           const void* dy, const void* ehr, const void* ehi, const void* ewr,
                           const void* ewi, void* dx, void* partial, int Hp, int Wp, int C,
                           int m2x2, int m3, int act, dim3 grid, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)C * C + 2 * (size_t)m3 * Wp + 2 * (size_t)m3 * C +
                       2 * (size_t)kWC * C + 4 * (size_t)C + 3 * (size_t)kThreads);
  auto kernel = k12b_kernel<T, MAXC>;
  cudaError_t err = fno::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(wp), static_cast<const T*>(s), static_cast<const T*>(ds),
      static_cast<const float*>(ds1), static_cast<const float*>(ds2),
      static_cast<const T*>(dy), static_cast<const float*>(ehr),
      static_cast<const float*>(ehi), static_cast<const float*>(ewr),
      static_cast<const float*>(ewi), static_cast<T*>(dx), static_cast<float*>(partial), Hp,
      Wp, C, m2x2, m3, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k12b(const void* x, const void* a, const void* b, const void* wp,
                        const void* s, const void* ds, const void* ds1, const void* ds2,
                        const void* dy, const void* ehr, const void* ehi, const void* ewr,
                        const void* ewi, void* dx, void* partial, void* out, int BT, int Hp,
                        int Wp, int C, int m2x2, int m3, int act, cudaStream_t stream) {
  if (C < 1 || C > 128 || kThreads % C != 0 || m2x2 < 1 || m3 < 1 || BT < 1 || Hp < 1 ||
      Wp < 1)
    return cudaErrorInvalidValue;
  const dim3 grid(BT, kSplit);
  cudaError_t err =
      C <= 64 ? launch_k12b_as<T, 64>(x, a, b, wp, s, ds, ds1, ds2, dy, ehr, ehi, ewr, ewi, dx,
                                      partial, Hp, Wp, C, m2x2, m3, act, grid, stream)
              : launch_k12b_as<T, 128>(x, a, b, wp, s, ds, ds1, ds2, dy, ehr, ehi, ewr, ewi, dx,
                                       partial, Hp, Wp, C, m2x2, m3, act, grid, stream);
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(out),
                              BT * kSplit, C * C + 3 * C, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core variant: two kernels, the dz pass and the dWp pass
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;        // bf16 padding of a [*, C] shared-memory row (ldmatrix banks)
constexpr int kMaxKH = 4;      // k-steps of the adjoint-H product: 2 * (2*m2) <= 64
constexpr int kGCols = 16;     // channels of dy a warp stages at a time
constexpr int kTilePos = 64;   // positions a dWp block stages at a time
constexpr int kMaxDwpParts = 512;   // blocks of the dWp pass

// H rows a dz block takes: (re | im) x rows fill at most one 16-row tile, and
// dX for them, hi and lo, fits beside Wp^T and the rings.
__host__ __device__ constexpr int dz_rows(int C) { return C <= 32 ? 8 : C <= 64 ? 5 : 4; }

// Byte offsets of a dz block's shared memory (ops/kernels.py::
// k12b_mma_smem_bytes computes the same total).
struct DzLayout {
  int wt_hi, wt_lo, dx, ring, vec, red, total;
};

inline DzLayout dz_layout(int C, int m3, int m2x2, int warps) {
  DzLayout L;
  const int row = (C + kPad) * 2;
  L.wt_hi = 0;
  L.wt_lo = L.wt_hi + C * row;
  L.dx = L.wt_lo + C * row;
  L.ring = L.dx + 2 * dz_rows(C) * 2 * m3 * row;        // hi and lo
  L.vec = L.ring + warps * 2 * (2 * m2x2) * kGCols * 2;  // per-warp two-stage ring over dy
  L.red = L.vec + 4 * C * 4;
  L.total = L.red + warps * 2 * C * 4;
  return L;
}

inline int dwp_smem(int C) { return 4 * 2 * kTilePos * (C + kPad) * 2 + 8 * C * 4; }

int dz_chunks(int Hp, int C) { return (Hp + dz_rows(C) - 1) / dz_rows(C); }
int dwp_tiles(long long npos) { return (int)((npos + kTilePos - 1) / kTilePos); }
int dwp_parts(long long npos) {
  const int tiles = dwp_tiles(npos);
  return tiles < kMaxDwpParts ? tiles : kMaxDwpParts;
}

// The dz pass. Per (bt, row h), warp = the 16 columns w0.. of W:
//   dz = [EWr | EWi] (16 x 2*m3) . dX_h (2*m3 x C) + ds_eff (16 x C) . Wp^T (C x C),
// one accumulator of depth 2*m3 + C, every operand a bf16 hi + lo pair
// (three MMAs a product); then du = dz * act'(a*x + b), dx = du * a and the
// per-channel sums da, db from the f32 accumulators. dX for the block's rows
// comes first, as K2's inverse H: dX = AH (16 x 2*2m2) . dy (2*2m2 x (m, c)).
template <int C, int KI, int MAXW, int MINB>
__global__ void __launch_bounds__(MAXW * 32, MINB)
    k12b_dz_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, const float* __restrict__ wp,
                   const bf16* __restrict__ s, const bf16* __restrict__ ds,
                   const float* __restrict__ ds1, const float* __restrict__ ds2,
                   const bf16* __restrict__ dy, const bf16* __restrict__ ah,
                   const bf16* __restrict__ ew, bf16* __restrict__ dx,
                   float* __restrict__ partial, DzLayout L, int Hp, int Wp, int m2x2, int act) {
  constexpr int M3 = KI * 8;
  constexpr int kRows = dz_rows(C);
  constexpr int RS = C + kPad;
  constexpr int NT = C / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* swt_hi = reinterpret_cast<bf16*>(smem_raw + L.wt_hi);   // [C][RS]: [d][c] = wp[c][d]
  bf16* swt_lo = reinterpret_cast<bf16*>(smem_raw + L.wt_lo);
  bf16* sdx = reinterpret_cast<bf16*>(smem_raw + L.dx);         // [2][kRows][2*M3][RS]
  bf16* sring = reinterpret_cast<bf16*>(smem_raw + L.ring);
  float* sa = reinterpret_cast<float*>(smem_raw + L.vec);       // [C] each: a, b, ds1, 2*ds2
  float* sb = sa + C;
  float* s1 = sb + C;
  float* s2 = s1 + C;
  float* sred = reinterpret_cast<float*>(smem_raw + L.red);     // [warps][2][C]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int chunk = blockIdx.x, nchunks = gridDim.x, bt = blockIdx.y;
  const int h0 = chunk * kRows;
  const int nrows = min(kRows, Hp - h0);

  // ---- constants: Wp^T split into hi + lo while staged; a, b, ds1, 2*ds2
  for (int i = tid; i < C * C; i += nthreads) {
    const int c = i / C, d = i - c * C;   // wp[c][d] -> [d][c]
    bf16 hi, lo;
    mma::split_bf16(wp[i], hi, lo);
    swt_hi[d * RS + c] = hi;
    swt_lo[d * RS + c] = lo;
  }
  for (int i = tid; i < C; i += nthreads) {
    sa[i] = a[i];
    sb[i] = b[i];
    s1[i] = ds1[i];
    s2[i] = 2.f * ds2[i];
  }

  // ---- adjoint H: sdx[hl][part*M3 + m][c] = sum_k AH[(part, hl)][k] * G[k][(m, c)],
  // k = (p', j): G[(p', j)][(m, c)] = dy[bt][j*M3 + m][p'*C + c]
  {
    const int K = 2 * m2x2;
    const int ksteps = (K + 15) / 16, Kpad = ksteps * 16;
    const bf16* gb = dy + (size_t)bt * m2x2 * M3 * 2 * C;
    const bf16* ah_hi = ah + (size_t)chunk * 16 * Kpad;
    const bf16* ah_lo = ah_hi + (size_t)nchunks * 16 * Kpad;
    bf16* gbuf = sring + warp * 2 * K * kGCols;
    constexpr int kPieces = M3 * (C / kGCols);
    auto fetch = [&](int p, int stage) {
      const int m = p / (C / kGCols), c0 = (p - m * (C / kGCols)) * kGCols;
      bf16* dst = gbuf + stage * K * kGCols;
      for (int i = lane; i < 2 * K; i += 32) {
        const int k = i >> 1, half = i & 1;
        const int pp = k / m2x2, j = k - pp * m2x2;
        mma::cp_async_16(dst + k * kGCols + half * 8,
                         gb + ((size_t)(j * M3 + m) * 2 * C + pp * C + c0 + half * 8));
      }
      mma::cp_async_commit();
    };
    if (warp < kPieces) fetch(warp, 0);
    uint32_t ahh[kMaxKH][4], ahl[kMaxKH][4];
#pragma unroll
    for (int ks = 0; ks < kMaxKH; ++ks) {
      if (ks >= ksteps) break;
      const int ka = ks * 16 + 2 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int off = (gq + (r & 1) * 8) * Kpad + ka + (r >> 1) * 8;
        ahh[ks][r] = *reinterpret_cast<const uint32_t*>(ah_hi + off);
        ahl[ks][r] = *reinterpret_cast<const uint32_t*>(ah_lo + off);
      }
    }
    int stage = 0;
    for (int p = warp; p < kPieces; p += nwarps, stage ^= 1) {
      if (p + nwarps < kPieces) {
        fetch(p + nwarps, stage ^ 1);
        mma::cp_async_wait<1>();
      } else {
        mma::cp_async_wait<0>();
      }
      __syncwarp();
      const bf16* gs = gbuf + stage * K * kGCols;
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxKH; ++ks) {
        if (ks >= ksteps) break;
        uint32_t fb[4];
        int k, n;
        mma::b_frag_row(lane, ks * 16, 0, k, n);
        if (k >= K) k = 0;   // AH is zero there; any finite row serves
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(gs + k * kGCols + n));
        mma::mma_bf16(acc[0], ahh[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[1], ahh[ks], fb[2], fb[3]);
        mma::mma_bf16(acc[0], ahl[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[1], ahl[ks], fb[2], fb[3]);
      }
      __syncwarp();
      const int m = p / (C / kGCols), c0 = (p - m * (C / kGCols)) * kGCols;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (gq >= kRows) break;
        bf16* o = sdx + ((size_t)gq * 2 * M3 + m) * RS + c0 + t * 8 + 2 * q;
        const uint32_t re = mma::pack_bf16(acc[t][0], acc[t][1]);
        const uint32_t im = mma::pack_bf16(acc[t][2], acc[t][3]);
        *reinterpret_cast<uint32_t*>(o) = re;
        *reinterpret_cast<uint32_t*>(o + M3 * RS) = im;
        const float2 rh = mma::unpack_bf16(re), ih = mma::unpack_bf16(im);
        o += kRows * 2 * M3 * RS;   // the lo parts
        *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(acc[t][0] - rh.x, acc[t][1] - rh.y);
        *reinterpret_cast<uint32_t*>(o + M3 * RS) =
            mma::pack_bf16(acc[t][2] - ih.x, acc[t][3] - ih.y);
      }
    }
    __syncthreads();   // sdx and the constants are complete
  }

  // ---- main loop: warp = the 16 columns w0.. of every row of the block
  const int w0 = warp * 16;
  const bool valid0 = w0 + gq < Wp, valid1 = w0 + gq + 8 < Wp;
  // forward-W A fragments, hi and lo: rows w0.., k = (part, m), from the packed table
  uint32_t ewh[KI][4], ewl[KI][4];
  {
    const bf16* t_hi = ew + (size_t)w0 * 2 * M3;
    const bf16* t_lo = t_hi + (size_t)nwarps * 16 * 2 * M3;
#pragma unroll
    for (int ks = 0; ks < KI; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int off = (gq + (r & 1) * 8) * 2 * M3 + ks * 16 + 2 * q + (r >> 1) * 8;
        ewh[ks][r] = *reinterpret_cast<const uint32_t*>(t_hi + off);
        ewl[ks][r] = *reinterpret_cast<const uint32_t*>(t_lo + off);
      }
  }
  float da[NT][2], db[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) da[t][0] = da[t][1] = db[t][0] = db[t][1] = 0.f;
  for (int hl = 0; hl < nrows; ++hl) {
    const size_t rowbase = ((size_t)bt * Hp + h0 + hl) * Wp * C + (size_t)w0 * C;
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    // spectral branch: EW (16 x 2*M3) . dX_h (2*M3 x C)
    const bf16* dxh = sdx + (size_t)hl * 2 * M3 * RS;
#pragma unroll
    for (int ks = 0; ks < KI; ++ks)
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        int k, n;
        mma::b_frag_row(lane, ks * 16, np * 16, k, n);
        uint32_t fb[4];
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(dxh + k * RS + n));
        mma::mma_bf16(acc[2 * np], ewh[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[2 * np + 1], ewh[ks], fb[2], fb[3]);
        mma::mma_bf16(acc[2 * np], ewl[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[2 * np + 1], ewl[ks], fb[2], fb[3]);
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(dxh + kRows * 2 * M3 * RS + k * RS + n));
        mma::mma_bf16(acc[2 * np], ewh[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[2 * np + 1], ewh[ks], fb[2], fb[3]);
      }
    // pointwise branch: ds_eff (16 x C) . Wp^T (C x C); ds_eff = ds + ds1 + 2*ds2*s is
    // made on the A fragment (its k index is the channel d), from 4-byte loads of
    // ds and s (a lane's pairs of one row fill whole 32-byte sectors), zero past Wp
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t dh[4], dl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = ks * 16 + 2 * q + (r >> 1) * 8;
        const bool ok = (r & 1) ? valid1 : valid0;
        float e0 = 0.f, e1 = 0.f;
        if (ok) {
          const size_t at = rowbase + (size_t)(gq + (r & 1) * 8) * C + d;
          const float2 dv = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(ds + at));
          const float2 sv = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(s + at));
          const float2 c1 = *reinterpret_cast<const float2*>(s1 + d);
          const float2 c2 = *reinterpret_cast<const float2*>(s2 + d);
          e0 = fmaf(c2.x, sv.x, dv.x + c1.x);
          e1 = fmaf(c2.y, sv.y, dv.y + c1.y);
        }
        dh[r] = mma::pack_bf16(e0, e1);
        const float2 h = mma::unpack_bf16(dh[r]);
        dl[r] = mma::pack_bf16(e0 - h.x, e1 - h.y);
      }
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        int k, n;
        mma::b_frag_row(lane, ks * 16, np * 16, k, n);
        uint32_t fh[4], fl[4];
        mma::ldmatrix_x4_trans(fh, mma::smem_addr(swt_hi + k * RS + n));
        mma::ldmatrix_x4_trans(fl, mma::smem_addr(swt_lo + k * RS + n));
        mma::mma_bf16(acc[2 * np], dh, fh[0], fh[1]);
        mma::mma_bf16(acc[2 * np + 1], dh, fh[2], fh[3]);
        mma::mma_bf16(acc[2 * np], dl, fh[0], fh[1]);
        mma::mma_bf16(acc[2 * np + 1], dl, fh[2], fh[3]);
        mma::mma_bf16(acc[2 * np], dh, fl[0], fl[1]);
        mma::mma_bf16(acc[2 * np + 1], dh, fl[2], fl[3]);
      }
    }
    // du = dz * act'(a*x + b), dx = du * a, da += du * x, db += du
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * 8 + 2 * q;
      const float2 av = *reinterpret_cast<const float2*>(sa + c);
      const float2 bv = *reinterpret_cast<const float2*>(sb + c);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!(hf ? valid1 : valid0)) continue;
        const size_t at = rowbase + (size_t)(gq + hf * 8) * C + c;
        const float2 xv = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at));
        const float du0 = acc[t][2 * hf] * fno::act_grad_fast(fmaf(av.x, xv.x, bv.x), act);
        const float du1 = acc[t][2 * hf + 1] * fno::act_grad_fast(fmaf(av.y, xv.y, bv.y), act);
        *reinterpret_cast<uint32_t*>(dx + at) = mma::pack_bf16(du0 * av.x, du1 * av.y);
        da[t][0] = fmaf(du0, xv.x, da[t][0]);
        da[t][1] = fmaf(du1, xv.y, da[t][1]);
        db[t][0] += du0;
        db[t][1] += du1;
      }
    }
  }

  // ---- the block's partial sums: lanes of a column pair, then warps, in a fixed order
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = da[t][i], w = db[t][i];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
        w += __shfl_xor_sync(0xffffffffu, w, off);
      }
      if (gq == 0) {
        sred[(warp * 2 + 0) * C + t * 8 + 2 * q + i] = v;
        sred[(warp * 2 + 1) * C + t * 8 + 2 * q + i] = w;
      }
    }
  __syncthreads();
  float* pb = partial + ((size_t)bt * nchunks + chunk) * 2 * C;
  for (int i = tid; i < 2 * C; i += nthreads) {
    float v = 0.f;
    for (int w = 0; w < nwarps; ++w) v += sred[w * 2 * C + i];
    pb[i] = v;
  }
}

// The dWp pass: dWp = z^T ds_eff over every position, and dbp = sum ds_eff. A
// block takes a fixed range of positions in tiles of kTilePos, staged by
// cp.async (two stages). Per tile the block first makes ds_eff, split into
// bf16 hi + lo, into two shared tiles (once for all warps; zero past the
// range) and adds it into each thread's dbp share; then warp v, which owns
// rows c = 16v.. of dWp and every column d, takes z^T as A fragments by
// ldmatrix.trans of the x tile (the affine and the activation act on the
// fragment: its row, the channel, is fixed per lane, so each z is made once)
// and ds_eff as B fragments of the hi and lo tiles: three MMAs a product.
template <int C>
__global__ void __launch_bounds__(C / 16 * 32)
    k12b_dwp_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ b, const bf16* __restrict__ s,
                    const bf16* __restrict__ ds, const float* __restrict__ ds1,
                    const float* __restrict__ ds2, float* __restrict__ partial, long long npos,
                    int tiles_per_block, int act) {
  constexpr int RS = C + kPad;
  constexpr int NT = C / 8;
  constexpr int kThr = C / 16 * 32;
  constexpr int kPairs = C / 2;               // channel pairs of a position
  constexpr int kGroups = kThr / kPairs;      // position groups of the ds_eff pass (4)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);   // [2][kTilePos][RS] each: x, s, ds
  bf16* ss = sx + 2 * kTilePos * RS;
  bf16* sd = ss + 2 * kTilePos * RS;
  bf16* eh = sd + 2 * kTilePos * RS;              // [kTilePos][RS]: ds_eff hi, then lo
  bf16* el = eh + kTilePos * RS;
  float* sa = reinterpret_cast<float*>(el + kTilePos * RS);   // [C] each: a, b, ds1, 2*ds2
  float* sb = sa + C;
  float* s1 = sb + C;
  float* s2 = s1 + C;
  float* sred = s2 + C;                           // [kGroups][C]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const long long p0 = (long long)blockIdx.x * tiles_per_block * kTilePos;
  const long long p1 = min(npos, p0 + (long long)tiles_per_block * kTilePos);
  const int ntiles = p1 > p0 ? (int)((p1 - p0 + kTilePos - 1) / kTilePos) : 0;

  // zero the staged tiles once: positions past the range are never copied,
  // and what the MMAs read there must be finite (ds_eff is zero there)
  for (int i = tid; i < 3 * 2 * kTilePos * RS / 8; i += kThr)
    reinterpret_cast<uint4*>(sx)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < C; i += kThr) {
    sa[i] = a[i];
    sb[i] = b[i];
    s1[i] = ds1[i];
    s2[i] = 2.f * ds2[i];
  }
  __syncthreads();
  auto fetch = [&](int t, int stage) {
    const long long base = p0 + (long long)t * kTilePos;
    const int n = (int)min((long long)kTilePos, p1 - base);
    for (int i = tid; i < 3 * n * (C / 8); i += kThr) {
      const int which = i / (n * (C / 8)), rem = i - which * n * (C / 8);
      const int p = rem / (C / 8), cc = rem - p * (C / 8);
      const bf16* src = which == 0 ? x : which == 1 ? s : ds;
      bf16* dst = (which == 0 ? sx : which == 1 ? ss : sd) + stage * kTilePos * RS;
      mma::cp_async_16(dst + p * RS + cc * 8, src + (size_t)(base + p) * C + cc * 8);
    }
    mma::cp_async_commit();
  };

  const int cw = warp * 16;   // this warp's rows of dWp
  const float a0 = sa[cw + gq], a8 = sa[cw + gq + 8], b0 = sb[cw + gq], b8 = sb[cw + gq + 8];
  // the ds_eff pass: thread (pair, group) takes channels 2*pair, 2*pair + 1 of
  // positions group, group + kGroups, ...
  const int pair = tid % kPairs, group = tid / kPairs, dc = 2 * pair;
  const float2 c1 = make_float2(s1[dc], s1[dc + 1]), c2 = make_float2(s2[dc], s2[dc + 1]);
  float bs0 = 0.f, bs1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  if (ntiles > 0) fetch(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      fetch(t + 1, stage ^ 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();   // tile t has landed for every thread
    const int nvalid = (int)min((long long)kTilePos, p1 - (p0 + (long long)t * kTilePos));
    const bf16* xs = sx + stage * kTilePos * RS;
    const bf16* sv = ss + stage * kTilePos * RS;
    const bf16* dv = sd + stage * kTilePos * RS;
    for (int p = group; p < kTilePos; p += kGroups) {
      float e0 = 0.f, e1 = 0.f;
      if (p < nvalid) {
        const float2 d = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(dv + p * RS + dc));
        const float2 f = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(sv + p * RS + dc));
        e0 = fmaf(c2.x, f.x, d.x + c1.x);
        e1 = fmaf(c2.y, f.y, d.y + c1.y);
        bs0 += e0;
        bs1 += e1;
      }
      const uint32_t hi = mma::pack_bf16(e0, e1);
      const float2 h = mma::unpack_bf16(hi);
      *reinterpret_cast<uint32_t*>(eh + p * RS + dc) = hi;
      *reinterpret_cast<uint32_t*>(el + p * RS + dc) = mma::pack_bf16(e0 - h.x, e1 - h.y);
    }
    __syncthreads();   // the ds_eff tiles are complete
#pragma unroll
    for (int ks = 0; ks < kTilePos / 16; ++ks) {
      if (ks * 16 >= nvalid) break;
      // A: z^T for rows cw.., positions ks*16..
      uint32_t zh[4], zl[4];
      {
        int k, m;
        mma::at_frag_row(lane, ks * 16, cw, k, m);
        mma::ldmatrix_x4_trans(zh, mma::smem_addr(xs + k * RS + m));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = mma::unpack_bf16(zh[r]);
          const float av = (r & 1) ? a8 : a0, bv = (r & 1) ? b8 : b0;
          const float z0 = fno::affine_act_fast(v.x, av, bv, act);
          const float z1 = fno::affine_act_fast(v.y, av, bv, act);
          zh[r] = mma::pack_bf16(z0, z1);
          const float2 h = mma::unpack_bf16(zh[r]);
          zl[r] = mma::pack_bf16(z0 - h.x, z1 - h.y);
        }
      }
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        int k, n;
        mma::b_frag_row(lane, ks * 16, np * 16, k, n);
        uint32_t fh[4], fl[4];
        mma::ldmatrix_x4_trans(fh, mma::smem_addr(eh + k * RS + n));
        mma::ldmatrix_x4_trans(fl, mma::smem_addr(el + k * RS + n));
        mma::mma_bf16(acc[2 * np], zh, fh[0], fh[1]);
        mma::mma_bf16(acc[2 * np + 1], zh, fh[2], fh[3]);
        mma::mma_bf16(acc[2 * np], zl, fh[0], fh[1]);
        mma::mma_bf16(acc[2 * np + 1], zl, fh[2], fh[3]);
        mma::mma_bf16(acc[2 * np], zh, fl[0], fl[1]);
        mma::mma_bf16(acc[2 * np + 1], zh, fl[2], fl[3]);
      }
    }
    __syncthreads();   // the stage and the ds_eff tiles are free
  }

  float* pb = partial + (size_t)blockIdx.x * (C * C + C);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int d = t * 8 + 2 * q;
    *reinterpret_cast<float2*>(pb + (cw + gq) * C + d) = make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(pb + (cw + gq + 8) * C + d) = make_float2(acc[t][2], acc[t][3]);
  }
  // dbp: the position groups' shares, added in a fixed order
  sred[group * C + dc] = bs0;
  sred[group * C + dc + 1] = bs1;
  __syncthreads();
  for (int i = tid; i < C; i += kThr) {
    float v = 0.f;
    for (int g = 0; g < kGroups; ++g) v += sred[g * C + i];
    pb[C * C + i] = v;
  }
}

template <int C, int KI, int MAXW, int MINB>
cudaError_t launch_k12b_mma_as(const void* x, const void* a, const void* b, const void* wp,
                               const void* s, const void* ds, const void* ds1, const void* ds2,
                               const void* dy, const void* ah, const void* ew, void* dx,
                               void* partial, void* out, int BT, int Hp, int Wp, int m2x2,
                               int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  // the dWp pass, into out[0 : C*C + C] = (dWp, dbp)
  const long long npos = (long long)BT * Hp * Wp;
  const int parts = dwp_parts(npos);
  const int per = (dwp_tiles(npos) + parts - 1) / parts;
  auto kb = k12b_dwp_kernel<C>;
  cudaError_t err = fno::allow_smem(kb, (size_t)dwp_smem(C));
  if (err != cudaSuccess) return err;
  kb<<<parts, C / 16 * 32, dwp_smem(C), stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(s), static_cast<const bf16*>(ds), static_cast<const float*>(ds1),
      static_cast<const float*>(ds2), static_cast<float*>(partial), npos, per, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(out), parts,
                             C * C + C, stream);
  if (err != cudaSuccess) return err;
  // the dz pass, into out[C*C + C : C*C + 3C] = (da, db)
  const DzLayout L = dz_layout(C, KI * 8, m2x2, warps);
  auto ka = k12b_dz_kernel<C, KI, MAXW, MINB>;
  err = fno::allow_smem(ka, (size_t)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ka, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ka<<<dim3(dz_chunks(Hp, C), BT), warps * 32, L.total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(wp), static_cast<const bf16*>(s), static_cast<const bf16*>(ds),
      static_cast<const float*>(ds1), static_cast<const float*>(ds2),
      static_cast<const bf16*>(dy), static_cast<const bf16*>(ah), static_cast<const bf16*>(ew),
      static_cast<bf16*>(dx), static_cast<float*>(partial), L, Hp, Wp, m2x2, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial),
                              static_cast<float*>(out) + C * C + C, BT * dz_chunks(Hp, C), 2 * C,
                              stream);
}

cudaError_t launch_k12b_mma(const void* x, const void* a, const void* b, const void* wp,
                            const void* s, const void* ds, const void* ds1, const void* ds2,
                            const void* dy, const void* ah, const void* ew, void* dx,
                            void* partial, void* out, int BT, int Hp, int Wp, int C, int m2x2,
                            int m3, int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  if (2 * m2x2 > 16 * kMaxKH || BT > 65535 || ah == nullptr || ew == nullptr)
    return cudaErrorInvalidValue;
  for (const void* p : {x, s, ds, dy, ah, ew, (const void*)dx})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
#define K12B_MMA(CC, KK, MW, MB)                                                               \
  if (C == CC && m3 == KK * 8 && warps <= MW)                                                  \
  return launch_k12b_mma_as<CC, KK, MW, MB>(x, a, b, wp, s, ds, ds1, ds2, dy, ah, ew, dx,      \
                                            partial, out, BT, Hp, Wp, m2x2, act, stream)
  K12B_MMA(64, 2, 9, 2);   // the cylinder and combustion: two blocks (18 warps) an SM
  K12B_MMA(128, 2, 9, 1);  // fsi
  K12B_MMA(32, 2, 16, 1);
  K12B_MMA(32, 1, 16, 1);
  K12B_MMA(64, 1, 16, 1);
  K12B_MMA(64, 2, 16, 1);
  K12B_MMA(128, 1, 9, 1);
#undef K12B_MMA
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The tf32 variant: the dz pass and the dWp pass on 3xTF32
// ---------------------------------------------------------------------------

using fno_tf32::kTPad;
constexpr int kTilePosT = 32;    // positions a tf32 dWp block stages at a time
constexpr int kDwpPartsT = 396;  // blocks of the tf32 dWp pass: three an SM at C 64 (132 SMs)

// Byte offsets of a tf32 dz block's shared memory (ops/kernels.py::
// k12b_tf32_smem_bytes computes the same total). The ring region holds the
// warps' dy rings during the H stage, then wp hi and lo.
struct DzTf32Layout {
  int dx, ring, vec, red, total;
};

inline DzTf32Layout dz_tf32_layout(int C, int m3, int m2x2, int warps) {
  DzTf32Layout L;
  const int wt = 2 * C * (C + kTPad) * 4;             // wp [C][C + kTPad] hi, lo; k permuted
  const int ring = warps * fno_tf32::h_ring_floats(m2x2) * 4;
  L.dx = 0;                                           // [rows][C][2*m3 + kTPad]
  L.ring = L.dx + dz_rows(C) * C * (2 * m3 + kTPad) * 4;
  L.vec = L.ring + (wt > ring ? wt : ring);
  L.red = L.vec + 4 * C * 4;
  L.total = L.red + warps * 2 * C * 4;
  return L;
}

// x, s and ds two stages each, ds_eff hi and lo, a/b/ds1/ds2, the position
// groups' dbp shares (four groups)
inline int dwp_tf32_smem(int C) {
  return (3 * 2 + 2) * kTilePosT * (C + 8) * 4 + 4 * C * 4 + 4 * C * 4;
}
int dwp_tf32_tiles(long long npos) { return (int)((npos + kTilePosT - 1) / kTilePosT); }
int dwp_tf32_parts(long long npos) {
  const int tiles = dwp_tf32_tiles(npos);
  return tiles < kDwpPartsT ? tiles : kDwpPartsT;
}

// The position of channel e (0..7) of a k-step in the permuted order
// 0 2 4 6 1 3 5 7: physical k q holds channel 2q, k q + 4 channel 2q + 1.
__device__ __forceinline__ int k_perm(int e) { return (e >> 1) + (e & 1) * 4; }

// The dz pass. Per (bt, row h), warp = the 16 columns w0.. of W:
//   dz = [EWr | EWi] (16 x 2*m3) . dX_h (2*m3 x C) + ds_eff (16 x C) . Wp^T (C x C)
// then du = dz * act'(a*x + b), dx = du * a and the per-channel sums da, db.
// ah: f32 [nchunks][16][Kpad] (the mma variant's adjoint-H rows, Kpad a
// multiple of 8); ew: f32 [16 * warps][2*m3], row w = [ewr[w] | ewi[w]].
template <int C, int KI, int MAXW, int MINB>
__global__ void __launch_bounds__(MAXW * 32, MINB)
    k12b_dz_tf32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                        const float* __restrict__ b, const float* __restrict__ wp,
                        const float* __restrict__ s, const float* __restrict__ ds,
                        const float* __restrict__ ds1, const float* __restrict__ ds2,
                        const float* __restrict__ dy, const float* __restrict__ ah,
                        const float* __restrict__ ew, float* __restrict__ dx,
                        float* __restrict__ partial, DzTf32Layout L, int Hp, int Wp, int m2x2,
                        int act) {
  constexpr int M3 = KI * 8;
  constexpr int K3 = 2 * M3;
  constexpr int kRows = dz_rows(C);
  constexpr int WS = C + kTPad;
  constexpr int IS = K3 + kTPad;
  constexpr int NT = C / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sdx = reinterpret_cast<float*>(smem_raw + L.dx);    // [kRows][C][IS]
  float* sring = reinterpret_cast<float*>(smem_raw + L.ring);
  float* swh = sring;           // after the H stage: [C][WS], [c][k_perm d] = hi(wp[c][d])
  float* swl = swh + C * WS;    // the lo parts
  float* sa = reinterpret_cast<float*>(smem_raw + L.vec);    // [C] each: a, b, ds1, 2*ds2
  float* sb = sa + C;
  float* s1 = sb + C;
  float* s2 = s1 + C;
  float* sred = reinterpret_cast<float*>(smem_raw + L.red);  // [warps][2][C]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int chunk = blockIdx.x, bt = blockIdx.y;
  const int h0 = chunk * kRows;
  const int nrows = min(kRows, Hp - h0);

  // ---- constants: a, b, ds1, 2*ds2
  for (int i = tid; i < C; i += nthreads) {
    sa[i] = a[i];
    sb[i] = b[i];
    s1[i] = ds1[i];
    s2[i] = 2.f * ds2[i];
  }

  // ---- adjoint H into sdx[hl][c][part*M3 + m]
  fno_tf32::h_stage<C, M3, kRows>(dy, ah, sdx, sring + warp * fno_tf32::h_ring_floats(m2x2), bt,
                                  chunk, m2x2, warp, nwarps, lane);
  __syncthreads();   // sdx and the constants are complete; the dy rings are free

  // ---- wp as a tf32 pair, each k-step's channels permuted
  for (int i = tid; i < C * C; i += nthreads) {
    const int c = i / C, d = i - c * C;
    uint32_t hi, lo;
    mma::split_tf32(wp[i], hi, lo);
    swh[c * WS + (d & ~7) + k_perm(d & 7)] = __uint_as_float(hi);
    swl[c * WS + (d & ~7) + k_perm(d & 7)] = __uint_as_float(lo);
  }
  __syncthreads();

  // ---- main loop: warp = the 16 columns w0.. of every row of the block
  const int w0 = warp * 16;
  const bool valid0 = w0 + gq < Wp, valid1 = w0 + gq + 8 < Wp;
  // forward-W A fragments in f32 (split for each row): rows w0.., k = (part, m)
  float ewf[K3 / 8][4];
#pragma unroll
  for (int ks = 0; ks < K3 / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ewf[ks][r] = ew[(size_t)(w0 + gq + (r & 1) * 8) * K3 + ks * 8 + q + (r >> 1) * 4];
  fno_tf32::ColumnSums<NT> sums;   // da, db
  for (int hl = 0; hl < nrows; ++hl) {
    const size_t rowbase = ((size_t)bt * Hp + h0 + hl) * Wp * C + (size_t)w0 * C;
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    // spectral branch: EW (16 x K3) . dX_h (K3 x C)
    const float* dxh = sdx + (size_t)hl * C * IS;
#pragma unroll
    for (int ks = 0; ks < K3 / 8; ++ks) {
      uint32_t fh[4], fl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) mma::split_tf32(ewf[ks][r], fh[r], fl[r]);
      fno_tf32::bt_product<C, IS>(acc, fh, fl, dxh, ks * 8, lane);
    }
    // pointwise branch: ds_eff (16 x C) . Wp^T (C x C), ds_eff = ds + ds1 +
    // 2*ds2*s made on the A fragment in the permuted k order: a lane's a0
    // and a2 are channels d, d + 1 of row gq (a1, a3 of row gq + 8), one
    // 8-byte load of ds and of s each; zero past Wp
#pragma unroll
    for (int ks = 0; ks < C / 8; ++ks) {
      const int d = ks * 8 + 2 * q;
      const float2 c1 = *reinterpret_cast<const float2*>(s1 + d);
      const float2 c2 = *reinterpret_cast<const float2*>(s2 + d);
      uint32_t eh[4], el[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float e0 = 0.f, e1 = 0.f;
        if (hf ? valid1 : valid0) {
          const size_t at = rowbase + (size_t)(gq + hf * 8) * C + d;
          const float2 dv = *reinterpret_cast<const float2*>(ds + at);
          const float2 sv = *reinterpret_cast<const float2*>(s + at);
          e0 = fmaf(c2.x, sv.x, dv.x + c1.x);
          e1 = fmaf(c2.y, sv.y, dv.y + c1.y);
        }
        mma::split_tf32(e0, eh[hf], el[hf]);
        mma::split_tf32(e1, eh[2 + hf], el[2 + hf]);
      }
      fno_tf32::bt_product_pair<C, WS>(acc, eh, el, swh, swl, ks * 8, lane);
    }
    // du = dz * act'(a*x + b), dx = du * a; the row's da (du * x) and db (du)
    float v[4 * NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * 8 + 2 * q;
      const float2 av = *reinterpret_cast<const float2*>(sa + c);
      const float2 bv = *reinterpret_cast<const float2*>(sb + c);
      v[4 * t + 0] = v[4 * t + 1] = v[4 * t + 2] = v[4 * t + 3] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!(hf ? valid1 : valid0)) continue;
        const size_t at = rowbase + (size_t)(gq + hf * 8) * C + c;
        const float2 xv = *reinterpret_cast<const float2*>(x + at);
        const float du0 = acc[t][2 * hf] * fno::act_grad_fast(fmaf(av.x, xv.x, bv.x), act);
        const float du1 = acc[t][2 * hf + 1] * fno::act_grad_fast(fmaf(av.y, xv.y, bv.y), act);
        *reinterpret_cast<float2*>(dx + at) = make_float2(du0 * av.x, du1 * av.y);
        v[4 * t + 0] = fmaf(du0, xv.x, v[4 * t + 0]);
        v[4 * t + 1] = fmaf(du1, xv.y, v[4 * t + 1]);
        v[4 * t + 2] += du0;
        v[4 * t + 3] += du1;
      }
    }
    sums.add(v, lane);
  }

  // ---- the block's partial sums: the warps' in a fixed order
  sums.store(sred, warp, lane);
  __syncthreads();
  float* pb = partial + ((size_t)bt * gridDim.x + chunk) * 2 * C;
  for (int i = tid; i < 2 * C; i += nthreads) {
    float v = 0.f;
    for (int w = 0; w < nwarps; ++w) v += sred[w * 2 * C + i];
    pb[i] = v;
  }
}

// The dWp pass: dWp = z^T ds_eff over every position, and dbp = sum ds_eff.
// A block takes a fixed range of positions in tiles of kTilePosT, staged by
// cp.async (two stages). Per tile the block first makes ds_eff, split into
// tf32 hi and lo tiles (once for all warps; zero past the range), and adds
// it into each thread's dbp share; then warp v, which owns rows c = 16v..
// of dWp and every column d, makes z^T's A fragments from 8-byte loads of
// the x tile (the affine and the activation on the fragment: each z made
// once) and takes ds_eff's B fragments from 8-byte loads of the hi and lo
// tiles: three MMAs a product.
template <int C>
__global__ void __launch_bounds__(C / 16 * 32)
    k12b_dwp_tf32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                         const float* __restrict__ b, const float* __restrict__ s,
                         const float* __restrict__ ds, const float* __restrict__ ds1,
                         const float* __restrict__ ds2, float* __restrict__ partial,
                         long long npos, int tiles_per_block, int act) {
  constexpr int S = C + 8;    // row stride: a half-warp's 8-byte loads at rows q, columns 2g
  constexpr int NT = C / 8;
  constexpr int P = kTilePosT;
  constexpr int kThr = C / 16 * 32;
  constexpr int kPairs = C / 2;               // channel pairs of a position
  constexpr int kGroups = kThr / kPairs;      // position groups of the ds_eff pass (4)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sx = reinterpret_cast<float*>(smem_raw);   // [2][P][S] each: x, s, ds
  float* ss = sx + 2 * P * S;
  float* sd = ss + 2 * P * S;
  float* eh = sd + 2 * P * S;                       // [P][S]: ds_eff hi, then lo
  float* el = eh + P * S;
  float* sa = el + P * S;                           // [C] each: a, b, ds1, 2*ds2
  float* sb = sa + C;
  float* s1 = sb + C;
  float* s2 = s1 + C;
  float* sred = s2 + C;                             // [kGroups][C]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const long long p0 = (long long)blockIdx.x * tiles_per_block * P;
  const long long p1 = min(npos, p0 + (long long)tiles_per_block * P);
  const int ntiles = p1 > p0 ? (int)((p1 - p0 + P - 1) / P) : 0;

  // zero the staged tiles once: positions past the range are never copied,
  // and what the MMAs read there must be finite (ds_eff is zero there)
  for (int i = tid; i < 3 * 2 * P * S / 4; i += kThr)
    reinterpret_cast<float4*>(sx)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < C; i += kThr) {
    sa[i] = a[i];
    sb[i] = b[i];
    s1[i] = ds1[i];
    s2[i] = 2.f * ds2[i];
  }
  __syncthreads();
  auto fetch = [&](int t, int stage) {
    const long long base = p0 + (long long)t * P;
    const int n = (int)min((long long)P, p1 - base);
    for (int i = tid; i < 3 * n * (C / 4); i += kThr) {
      const int which = i / (n * (C / 4)), rem = i - which * n * (C / 4);
      const int p = rem / (C / 4), cc = rem - p * (C / 4);
      const float* src = which == 0 ? x : which == 1 ? s : ds;
      float* dst = (which == 0 ? sx : which == 1 ? ss : sd) + stage * P * S;
      mma::cp_async_16(dst + p * S + cc * 4, src + (size_t)(base + p) * C + cc * 4);
    }
    mma::cp_async_commit();
  };

  // this warp's rows of dWp: A row g is c = cw + 2g, row g + 8 is c = cw + 2g + 1
  const int cw = warp * 16, cr = cw + 2 * gq;
  const float2 av = make_float2(sa[cr], sa[cr + 1]), bv = make_float2(sb[cr], sb[cr + 1]);
  // the ds_eff pass: thread (pair, group) takes channels 2*pair, 2*pair + 1 of
  // positions group, group + kGroups, ...
  const int pair = tid % kPairs, group = tid / kPairs, dc = 2 * pair;
  const float2 c1 = make_float2(s1[dc], s1[dc + 1]), c2 = make_float2(s2[dc], s2[dc + 1]);
  float bs0 = 0.f, bs1 = 0.f;
  // the MMAs add into acc for one tile, then acc is added into tot by FADD:
  // one chain of ~7000 tensor-core accumulations a block (their adds do not
  // round to nearest) put 1e-4 of the terms on dWp at the training width
  float acc[NT][4], tot[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) tot[t][0] = tot[t][1] = tot[t][2] = tot[t][3] = 0.f;

  if (ntiles > 0) fetch(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
#pragma unroll
    for (int u = 0; u < NT; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
    if (t + 1 < ntiles) {
      fetch(t + 1, stage ^ 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();   // tile t has landed for every thread
    const int nvalid = (int)min((long long)P, p1 - (p0 + (long long)t * P));
    const float* xs = sx + stage * P * S;
    const float* sv = ss + stage * P * S;
    const float* dv = sd + stage * P * S;
    for (int p = group; p < P; p += kGroups) {
      float e0 = 0.f, e1 = 0.f;
      if (p < nvalid) {
        const float2 d = *reinterpret_cast<const float2*>(dv + p * S + dc);
        const float2 f = *reinterpret_cast<const float2*>(sv + p * S + dc);
        e0 = fmaf(c2.x, f.x, d.x + c1.x);
        e1 = fmaf(c2.y, f.y, d.y + c1.y);
        bs0 += e0;
        bs1 += e1;
      }
      uint32_t h0, l0, h1, l1;
      mma::split_tf32(e0, h0, l0);
      mma::split_tf32(e1, h1, l1);
      *reinterpret_cast<float2*>(eh + p * S + dc) = make_float2(__uint_as_float(h0),
                                                                __uint_as_float(h1));
      *reinterpret_cast<float2*>(el + p * S + dc) = make_float2(__uint_as_float(l0),
                                                                __uint_as_float(l1));
    }
    __syncthreads();   // the ds_eff tiles are complete
#pragma unroll
    for (int ks = 0; ks < P / 8; ++ks) {
      if (ks * 8 >= nvalid) break;
      // A: z^T at rows (c, c + 1) = (a0, a1), positions ks*8 + q; (a2, a3) at + 4
      const float2 xa = *reinterpret_cast<const float2*>(xs + (ks * 8 + q) * S + cr);
      const float2 xb = *reinterpret_cast<const float2*>(xs + (ks * 8 + q + 4) * S + cr);
      uint32_t zh[4], zl[4];
      mma::split_tf32(fno::affine_act_fast(xa.x, av.x, bv.x, act), zh[0], zl[0]);
      mma::split_tf32(fno::affine_act_fast(xa.y, av.y, bv.y, act), zh[1], zl[1]);
      mma::split_tf32(fno::affine_act_fast(xb.x, av.x, bv.x, act), zh[2], zl[2]);
      mma::split_tf32(fno::affine_act_fast(xb.y, av.y, bv.y, act), zh[3], zl[3]);
#pragma unroll
      for (int u = 0; u < C / 16; ++u) {
        // B: column g of tile 2u is d = 16u + 2g, of tile 2u + 1 d = 16u + 2g + 1
        const int off = (ks * 8 + q) * S + 16 * u + 2 * gq;
        const float2 h0 = *reinterpret_cast<const float2*>(eh + off);
        const float2 h1 = *reinterpret_cast<const float2*>(eh + off + 4 * S);
        const float2 l0 = *reinterpret_cast<const float2*>(el + off);
        const float2 l1 = *reinterpret_cast<const float2*>(el + off + 4 * S);
        mma::mma_tf32x3(acc[2 * u], zh, zl, __float_as_uint(h0.x), __float_as_uint(h1.x),
                        __float_as_uint(l0.x), __float_as_uint(l1.x));
        mma::mma_tf32x3(acc[2 * u + 1], zh, zl, __float_as_uint(h0.y), __float_as_uint(h1.y),
                        __float_as_uint(l0.y), __float_as_uint(l1.y));
      }
    }
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[u][i] += acc[u][i];
    __syncthreads();   // the stage and the ds_eff tiles are free
  }

  // sum (row g, column 2q) of tile 2u is dWp[c][16u + 4q], column
  // 2q + 1 is d + 2; tile 2u + 1 adds one to d; rows g + 8 are c + 1
  float* pb = partial + (size_t)blockIdx.x * (C * C + C);
#pragma unroll
  for (int u = 0; u < C / 16; ++u) {
    const int d = 16 * u + 4 * q;
    *reinterpret_cast<float4*>(pb + (size_t)cr * C + d) =
        make_float4(tot[2 * u][0], tot[2 * u + 1][0], tot[2 * u][1], tot[2 * u + 1][1]);
    *reinterpret_cast<float4*>(pb + (size_t)(cr + 1) * C + d) =
        make_float4(tot[2 * u][2], tot[2 * u + 1][2], tot[2 * u][3], tot[2 * u + 1][3]);
  }
  // dbp: the position groups' shares, added in a fixed order
  sred[group * C + dc] = bs0;
  sred[group * C + dc + 1] = bs1;
  __syncthreads();
  for (int i = tid; i < C; i += kThr) {
    float v = 0.f;
    for (int g = 0; g < kGroups; ++g) v += sred[g * C + i];
    pb[C * C + i] = v;
  }
}

template <int C, int KI, int MAXW, int MINB>
cudaError_t launch_k12b_tf32_as(const void* x, const void* a, const void* b, const void* wp,
                                const void* s, const void* ds, const void* ds1, const void* ds2,
                                const void* dy, const void* ah, const void* ew, void* dx,
                                void* partial, void* out, int BT, int Hp, int Wp, int m2x2,
                                int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  // the dWp pass, into out[0 : C*C + C] = (dWp, dbp)
  const long long npos = (long long)BT * Hp * Wp;
  const int parts = dwp_tf32_parts(npos);
  const int per = (dwp_tf32_tiles(npos) + parts - 1) / parts;
  auto kb = k12b_dwp_tf32_kernel<C>;
  cudaError_t err = fno::allow_smem(kb, (size_t)dwp_tf32_smem(C));
  if (err != cudaSuccess) return err;
  kb<<<parts, C / 16 * 32, dwp_tf32_smem(C), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(s), static_cast<const float*>(ds),
      static_cast<const float*>(ds1), static_cast<const float*>(ds2),
      static_cast<float*>(partial), npos, per, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(out), parts,
                             C * C + C, stream);
  if (err != cudaSuccess) return err;
  // the dz pass, into out[C*C + C : C*C + 3C] = (da, db)
  const DzTf32Layout L = dz_tf32_layout(C, KI * 8, m2x2, warps);
  auto ka = k12b_dz_tf32_kernel<C, KI, MAXW, MINB>;
  err = fno::allow_smem(ka, (size_t)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ka, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ka<<<dim3(dz_chunks(Hp, C), BT), warps * 32, L.total, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(wp), static_cast<const float*>(s),
      static_cast<const float*>(ds), static_cast<const float*>(ds1),
      static_cast<const float*>(ds2), static_cast<const float*>(dy),
      static_cast<const float*>(ah), static_cast<const float*>(ew), static_cast<float*>(dx),
      static_cast<float*>(partial), L, Hp, Wp, m2x2, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial),
                              static_cast<float*>(out) + C * C + C, BT * dz_chunks(Hp, C), 2 * C,
                              stream);
}

cudaError_t launch_k12b_tf32(const void* x, const void* a, const void* b, const void* wp,
                             const void* s, const void* ds, const void* ds1, const void* ds2,
                             const void* dy, const void* ah, const void* ew, void* dx,
                             void* partial, void* out, int BT, int Hp, int Wp, int C, int m2x2,
                             int m3, int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  if (2 * m2x2 > 8 * fno_tf32::kMaxKH || BT > 65535 || ah == nullptr || ew == nullptr)
    return cudaErrorInvalidValue;
  for (const void* p : {x, s, ds, dy, ah, ew, (const void*)dx})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
#define K12B_TF32(CC, KK, MW, MB)                                                             \
  if (C == CC && m3 == KK * 8 && warps <= MW)                                                 \
  return launch_k12b_tf32_as<CC, KK, MW, MB>(x, a, b, wp, s, ds, ds1, ds2, dy, ah, ew, dx,    \
                                             partial, out, BT, Hp, Wp, m2x2, act, stream)
  K12B_TF32(64, 2, 9, 2);   // the cylinder and combustion: two blocks (18 warps) an SM
  K12B_TF32(128, 2, 9, 1);  // fsi
  K12B_TF32(32, 2, 16, 1);
  K12B_TF32(32, 1, 16, 1);
  K12B_TF32(64, 1, 16, 1);
  K12B_TF32(64, 2, 16, 1);
  K12B_TF32(128, 1, 9, 1);
#undef K12B_TF32
  return cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 fma, 1 mma, 2 tf32 (ops/kernels.py: VARIANTS["k12b"]). Floats of
// scratch the caller allocates for the partials, and the shared memory of a
// dz block.
extern "C" long long fno_k12b_partial_floats(int BT, int Hp, int Wp, int C, int variant) {
  if (variant == 0) return (long long)BT * kSplit * (C * C + 3 * C);
  const long long npos = (long long)BT * Hp * Wp;
  const long long dz = (long long)BT * dz_chunks(Hp, C) * 2 * C;
  const long long dwp =
      (long long)(variant == 2 ? dwp_tf32_parts(npos) : dwp_parts(npos)) * (C * C + C);
  return dz > dwp ? dz : dwp;
}

extern "C" int fno_k12b_mma_smem_bytes(int Wp, int C, int m2x2, int m3) {
  return dz_layout(C, m3, m2x2, (Wp + 15) / 16).total;
}

extern "C" int fno_k12b_tf32_smem_bytes(int Wp, int C, int m2x2, int m3) {
  return dz_tf32_layout(C, m3, m2x2, (Wp + 15) / 16).total;
}

// ah, ew: the packed bf16 hi/lo tables of the mma variant, or the f32 tables
// of the tf32 variant (null for fma).
// out: fma (dWp, da, db, dbp); mma and tf32 (dWp, dbp, da, db).
extern "C" int fno_k12b(const void* x, const void* a, const void* b, const void* wp,
                        const void* s, const void* ds, const void* ds1, const void* ds2,
                        const void* dy, const void* ehr, const void* ehi, const void* ewr,
                        const void* ewi, const void* ah, const void* ew, void* dx, void* partial,
                        void* out, int BT, int Hp, int Wp, int C, int m2x2, int m3, int act,
                        int variant, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || m2x2 < 1 || m3 < 1 || BT < 1 || Hp < 1 || Wp < 1) return cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != fno::kBF16) return cudaErrorInvalidValue;
    return launch_k12b_mma(x, a, b, wp, s, ds, ds1, ds2, dy, ah, ew, dx, partial, out, BT, Hp,
                           Wp, C, m2x2, m3, act, st);
  }
  if (variant == 2) {
    if (dtype != fno::kF32) return cudaErrorInvalidValue;
    return launch_k12b_tf32(x, a, b, wp, s, ds, ds1, ds2, dy, ah, ew, dx, partial, out, BT, Hp,
                            Wp, C, m2x2, m3, act, st);
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == fno::kF32)
    return launch_k12b<float>(x, a, b, wp, s, ds, ds1, ds2, dy, ehr, ehi, ewr, ewi, dx, partial,
                              out, BT, Hp, Wp, C, m2x2, m3, act, st);
  if (dtype == fno::kBF16)
    return launch_k12b<__nv_bfloat16>(x, a, b, wp, s, ds, ds1, ds2, dy, ehr, ehi, ewr, ewi, dx,
                                      partial, out, BT, Hp, Wp, C, m2x2, m3, act, st);
  return cudaErrorInvalidValue;
}
