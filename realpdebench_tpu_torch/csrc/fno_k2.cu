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
//   partial [fno_k2_num_partials, 2, C] (f32) scratch; stats [2, C] (f32)
//
// What bounds it on an H100: bytes. At rollout width a launch moves 520 MB
// (0.155 ms at 3.35 TB/s) and needs 27 GFLOP, which FP32 FMAs fed from shared
// memory deliver at a fifth of the FP32 peak (the shared-memory load port
// sets the pace), but which hide under the copies on the tensor cores. What
// is left beside the copies is the instruction stream: the activation (one erf
// per element of x), the statistics and the repacking around the MMAs.
//
// Three variants, chosen from dtype and shape before the launch
// (ops/kernels.py::k2_variant):
//
//  * mma (bf16, C in {32, 64, 128}, m3 in {8, 16}, 2*m2 <= 32, Wp <= 256): per
//    (bt, h) row the kernel computes one product of depth C + 2*m3,
//      s[w, :] = [z_h | IWr^T | IWi^T] (Wp x (C+2m3)) . [Wp ; ihr_h ; ihi_h],
//    with mma.sync m16n8k16 (bf16 in, f32 accumulators in registers), and the
//    inverse H DFT before it, ih = [Er^T, -Ei^T ; Ei^T, Er^T] . [gr ; gi], as
//    another. A block owns mma_rows(C) rows of H of one bt (5 at C 64), a
//    warp the 16 columns w0..w0+15 of every row (Wp/16 warps).
//      - Every operand carries 16 bits as a bf16 hi + lo pair (mma.cuh),
//        three MMAs a product (hi.hi + lo.hi + hi.lo). One bf16 would not do:
//        on Wp and the DFT tables it is the same 2^-9 error at every position
//        and lands in the BatchNorm sums; z = act(a*x + b) is made from x on
//        the bf16 grid, so its rounding is no random error either; and ih's
//        rounding, shared by a row's Wp columns, leaves 1e-4 on the sum of
//        squares at a few hundred rows. The DFT tables are packed on the
//        host once per geometry (ops/fno_layer.py::_k2_mma_tables); Wp, a
//        parameter, is split while it is staged; z and ih in registers.
//      - Inverse H: a warp takes the 16-channel pieces (m, c0..c0+15) of
//        g[bt] in turn, each through its own two-stage cp.async ring of
//        [k][16] tiles (1.5 KB), read with ldmatrix.trans as the B operand;
//        the block's constant A fragments stay in registers. No block-wide
//        barrier stands between the pieces (a block-wide ring over g cost
//        two barriers a stage and 40% of the block's time). The result lands
//        in shared memory as bf16 hi and lo in the [k][n] layout the main
//        product's B operand wants; one barrier ends the stage.
//      - Main loop: each warp runs its own two-stage cp.async ring over its
//        16 x C slab of x (contiguous 2 KB in global memory), so the next
//        row's copy overlaps this row's products and no block-wide barrier
//        stands in the loop. x arrives as A fragments through ldmatrix; the
//        affine, the activation (the exact GELU through a branch-free erf,
//        a third of erff's instructions) and the split to bf16 are
//        elementwise on the fragment. The IW fragments stay in registers for
//        the whole block. The statistics are taken from the f32
//        accumulators; the s tile goes back through the warp's slab and
//        leaves as 16-byte stores of whole lines.
//    Shared memory at C 64, m3 16, 2*m2 24, Wp 134: 111 KB, two blocks (18
//    warps) an SM; 96 registers a thread (18 warps on four register files).
//  * tf32 (f32 tensors; the mma variant's widths, W modes, H modes and warps,
//    16-byte aligned g, x, wp): the mma variant's block plan (mma_rows(C)
//    rows of H of one bt, one warp per 16 columns of W, a per-warp cp.async
//    ring over x, statistics from the f32 accumulators, partials through
//    fno::reduce_partials) with every product as 3xTF32 (mma.cuh:
//    hi.hi + hi.lo + lo.hi on mma.sync m16n8k8, the f32 analogue of the
//    bf16 pair; the sum carries 22 bits where the bf16 pair of the same f32
//    operands carries 16). ih is stored once, f32, as [hl][c][k] and split
//    in registers on the fragment (re-split by every warp: one f32 copy is
//    what fits); Wp^T ([d][c]) is staged as a tf32 hi + lo pair once a
//    block, after the H stage, in the memory the g rings leave; both are
//    [n][k] layouts whose tf32 B fragments ldmatrix gives (fno_tf32.cuh).
//    The DFT tables are f32 from the host (ops/fno_layer.py::
//    _k2_tf32_tables). The H stage is fno_tf32.cuh's h_stage, over
//    8-channel pieces of g. The exact GELU's erf is fno::erf_fast (A&S
//    7.1.26, |error| <= 3e-7, the size of 3xTF32's own error), as in the
//    mma variant; the fma variant keeps erff.
//      - The x ring in f32 would double: two-stage per-warp slabs of a whole
//        row take 145 KB a block at C 64, one block an SM. The ring is of
//        16-channel stages instead (a row is C/16 of them, consumed in
//        order, the next one in flight): 2.5 KB a warp; the block takes
//        107 KB at C 64, two blocks (18 warps) an SM. What it costs: a
//        cp.async wait and two warp barriers per 16 channels rather than
//        per row, and the s tile leaves from the accumulators as 8-byte
//        stores (four lanes fill a 32-byte sector) instead of through the
//        slab.
//      - What bounds it: latency at 18 warps an SM and 96 registers a
//        thread (tools/torch_tf32_probe.py: one block an SM with 167
//        registers is slower; cutting the activation, the B splits or the
//        MMAs each save a fifth). Per row and warp the pointwise and
//        inverse-W products are 288 tf32 MMAs beside the activation and
//        the splits of the z and ih fragments. The statistics are
//        fno_tf32.cuh's ColumnSums: four running sums a lane, not 32.
//        ptxas (-Xptxas -v, sm_90a): 96 registers and 84 bytes of spill
//        stores at <64, 2, 9, 2>; 168 and 16 at fsi's <128, 2, 9, 1>; the
//        other instantiations 116-168 registers, no spills.
//  * fma (f32 tensors at other shapes, misaligned views, and bf16 when named;
//    C dividing 256 up to 128, any m3): one block per (bt, fma_rows
//    rows of H); the block inverts H for its rows into shared memory, then
//    for each row stages z[h] and lets thread (d, column group) produce kWQ
//    output columns of channel d at once with exact f32 FMAs.
//
// Blocks run in no order, so the statistics take two passes in every
// variant: each block writes its own (sum, sumsq) partial in a fixed
// order, and fno::reduce_partials adds the partials in a fixed order in
// f64: the same bits on every call.
#include <cstdint>
#include <initializer_list>

#include "fno_common.cuh"
#include "fno_tf32.cuh"
#include "mma.cuh"

namespace {

// H rows per block: their inverse-H rows sit in shared memory beside Wp and
// a row of z, 2 at C 128 so that the block fits 227 KB
__host__ __device__ constexpr int fma_rows(int C) { return C > 64 ? 2 : 5; }
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
  const int kHT = fma_rows(C);
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

int num_hblocks(int Hp, int C) { return (Hp + fma_rows(C) - 1) / fma_rows(C); }

template <typename T>
cudaError_t launch_k2(const void* g, const void* x, const void* a, const void* b,
                      const void* wp, const void* bp, const void* ihr, const void* ihi,
                      const void* iwr, const void* iwi, void* s, void* partial, void* stats,
                      int BT, int Hp, int Wp, int C, int m2x2, int m3, int act,
                      cudaStream_t stream) {
  if (C > kThreads || kThreads % C != 0) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)C * C + 2 * (size_t)m3 * Wp + 2 * (size_t)fma_rows(C) * m3 * C +
                       (size_t)Wp * C + 3 * (size_t)C + 2 * (size_t)kThreads);
  cudaError_t err = fno::allow_smem(k2_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BT, num_hblocks(Hp, C));
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
                              BT * num_hblocks(Hp, C), 2 * C, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core variant
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;       // bf16 elements of padding per shared-memory row: rows 16 bytes
                              // apart modulo 128, so ldmatrix reads without bank conflicts
constexpr int kMaxWarps = 16; // Wp <= 256
constexpr int kMaxKH = 4;     // k-steps of the inverse-H product: 2 * (2*m2) <= 64
constexpr int kGCols = 16;    // channels of g a warp stages at a time: one pair of 8-column tiles

// Byte offsets of the block's shared memory (ops/kernels.py::k2_mma_smem_bytes
// computes the same total).
struct MmaLayout {
  int wp_hi, wp_lo, ih, ring, vec, red, total;
};

// H rows per block: (re | im) x rows fill at most one 16-row MMA tile, and
// ih for them, hi and lo, has to fit beside Wp and the rings.
__host__ __device__ constexpr int mma_rows(int C) { return C <= 32 ? 8 : C <= 64 ? 5 : 3; }

inline MmaLayout mma_layout(int C, int m3, int m2x2, int warps) {
  MmaLayout L;
  const int row = (C + kPad) * 2;                   // bytes of a [*, C] bf16 row
  const int slabs = warps * 2 * 16 * row;           // per-warp two-stage x ring
  const int gring = warps * 2 * (2 * m2x2) * kGCols * 2;   // per-warp two-stage ring over g
  L.wp_hi = 0;
  L.wp_lo = L.wp_hi + C * row;
  L.ih = L.wp_lo + C * row;
  L.ring = L.ih + 2 * mma_rows(C) * 2 * m3 * row;   // hi and lo
  L.vec = L.ring + (slabs > gring ? slabs : gring);
  L.red = L.vec + 3 * C * 4;
  L.total = L.red + warps * 2 * C * 4;
  return L;
}

// C channels, KI = m3/8 k-steps of the inverse-W part, at most MAXW warps
// with MINB blocks an SM.
template <int C, int KI, int MAXW, int MINB>
__global__ void __launch_bounds__(MAXW * 32, MINB)
    k2_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ wp, const float* __restrict__ bp,
                  const bf16* __restrict__ ah, const bf16* __restrict__ iw,
                  bf16* __restrict__ s, float* __restrict__ partial, MmaLayout L, int Hp, int Wp,
                  int m2x2, int act) {
  constexpr int M3 = KI * 8;
  constexpr int kRows = mma_rows(C);
  constexpr int RS = C + kPad;       // row stride of the [*, C] tiles, elements
  constexpr int NT = C / 8;          // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* swp_hi = reinterpret_cast<bf16*>(smem_raw + L.wp_hi);   // [C][RS], [in][out]
  bf16* swp_lo = reinterpret_cast<bf16*>(smem_raw + L.wp_lo);
  bf16* sih = reinterpret_cast<bf16*>(smem_raw + L.ih);         // [kRows][2*M3][RS]
  bf16* sring = reinterpret_cast<bf16*>(smem_raw + L.ring);
  float* sa = reinterpret_cast<float*>(smem_raw + L.vec);       // [C] each
  float* sb = sa + C;
  float* sbp = sb + C;
  float* sred = reinterpret_cast<float*>(smem_raw + L.red);     // [warps][2][C]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int gq = lane >> 2, q = lane & 3;   // fragment row group and column pair
  const int chunk = blockIdx.x, nchunks = gridDim.x, bt = blockIdx.y;
  const int h0 = chunk * kRows;
  const int nrows = min(kRows, Hp - h0);

  // ---- constants: Wp split into hi + lo while staged; a, b, bp
  for (int i = tid; i < C * C / 4; i += nthreads) {
    const float4 v = reinterpret_cast<const float4*>(wp)[i];
    const int c = (i * 4) / C, d = (i * 4) % C;
    const float w[4] = {v.x, v.y, v.z, v.w};
    __align__(8) bf16 hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) mma::split_bf16(w[u], hi[u], lo[u]);
    *reinterpret_cast<uint2*>(swp_hi + c * RS + d) = *reinterpret_cast<const uint2*>(hi);
    *reinterpret_cast<uint2*>(swp_lo + c * RS + d) = *reinterpret_cast<const uint2*>(lo);
  }
  for (int i = tid; i < C; i += nthreads) {
    sa[i] = a[i];
    sb[i] = b[i];
    sbp[i] = bp[i];
  }

  // ---- inverse H: sih[hl][part*M3 + m][c] = sum_k AH[(part, hl)][k] * G[k][(m, c)],
  // k = (p', j): G[(p', j)][(m, c)] = g[bt][j*M3 + m][p'*C + c]. A warp takes the
  // 16-channel pieces (m, c0..c0+15) in turn, each through its own two-stage
  // cp.async ring ([k][16] tiles): no block-wide barrier until all is done.
  {
    const int K = 2 * m2x2;
    const int ksteps = (K + 15) / 16, Kpad = ksteps * 16;
    const bf16* gb = g + (size_t)bt * m2x2 * M3 * 2 * C;
    const bf16* ah_hi = ah + (size_t)chunk * 16 * Kpad;
    const bf16* ah_lo = ah_hi + (size_t)nchunks * 16 * Kpad;
    bf16* gbuf = sring + warp * 2 * K * kGCols;   // [2 stages][K][kGCols]
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
    // the block's constant A fragments, hi and lo, while the first piece flies
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
      __syncwarp();   // piece p has landed for every lane
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
      __syncwarp();   // the stage is free for the piece after next
      const int m = p / (C / kGCols), c0 = (p - m * (C / kGCols)) * kGCols;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (gq >= kRows) break;   // the tile's unused rows
        // accumulator rows: gq is (re, hl = gq), gq + 8 is (im, hl = gq)
        bf16* o = sih + ((size_t)gq * 2 * M3 + m) * RS + c0 + t * 8 + 2 * q;
        const uint32_t re = mma::pack_bf16(acc[t][0], acc[t][1]);
        const uint32_t im = mma::pack_bf16(acc[t][2], acc[t][3]);
        *reinterpret_cast<uint32_t*>(o) = re;
        *reinterpret_cast<uint32_t*>(o + M3 * RS) = im;
        const float2 rh = mma::unpack_bf16(re), ih_ = mma::unpack_bf16(im);
        o += kRows * 2 * M3 * RS;   // the lo parts
        *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(acc[t][0] - rh.x, acc[t][1] - rh.y);
        *reinterpret_cast<uint32_t*>(o + M3 * RS) =
            mma::pack_bf16(acc[t][2] - ih_.x, acc[t][3] - ih_.y);
      }
    }
    __syncthreads();   // sih and the constants are complete; the g rings are free
  }

  // ---- main loop: warp = the 16 columns w0.. of every row of the block
  const int w0 = warp * 16;
  const int nvalid = min(16, Wp - w0);
  bf16* slab = sring + warp * 2 * 16 * RS;   // [2 stages][16][RS]
  // pad rows of both stages stay zero: no copy and no store touches them
  for (int i = lane; i < 2 * 16 * (C / 8); i += 32) {
    const int r = i / (C / 8), cc = i - r * (C / 8);
    if ((r & 15) >= nvalid) *reinterpret_cast<uint4*>(slab + r * RS + cc * 8) = make_uint4(0, 0, 0, 0);
  }
  // inverse-W A fragments, hi and lo: rows w0.., k = (part, m), from the packed table
  uint32_t iwh[KI][4], iwl[KI][4];
  {
    const bf16* t_hi = iw + (size_t)w0 * 2 * M3;
    const bf16* t_lo = t_hi + (size_t)nwarps * 16 * 2 * M3;
#pragma unroll
    for (int ks = 0; ks < KI; ++ks) {
      const int k = ks * 16 + 2 * q;
      iwh[ks][0] = *reinterpret_cast<const uint32_t*>(t_hi + gq * 2 * M3 + k);
      iwh[ks][1] = *reinterpret_cast<const uint32_t*>(t_hi + (gq + 8) * 2 * M3 + k);
      iwh[ks][2] = *reinterpret_cast<const uint32_t*>(t_hi + gq * 2 * M3 + k + 8);
      iwh[ks][3] = *reinterpret_cast<const uint32_t*>(t_hi + (gq + 8) * 2 * M3 + k + 8);
      iwl[ks][0] = *reinterpret_cast<const uint32_t*>(t_lo + gq * 2 * M3 + k);
      iwl[ks][1] = *reinterpret_cast<const uint32_t*>(t_lo + (gq + 8) * 2 * M3 + k);
      iwl[ks][2] = *reinterpret_cast<const uint32_t*>(t_lo + gq * 2 * M3 + k + 8);
      iwl[ks][3] = *reinterpret_cast<const uint32_t*>(t_lo + (gq + 8) * 2 * M3 + k + 8);
    }
  }
  const size_t rowbase = ((size_t)bt * Hp + h0) * Wp * C + (size_t)w0 * C;
  const int pieces = nvalid * (C / 8);   // 16-byte pieces of the warp's slab of one row
  auto fetch_x = [&](int hl) {
    const bf16* src = x + rowbase + (size_t)hl * Wp * C;
    bf16* dst = slab + (hl & 1) * 16 * RS;
    for (int i = lane; i < pieces; i += 32) {
      const int r = i / (C / 8), cc = i - r * (C / 8);
      mma::cp_async_16(dst + r * RS + cc * 8, src + i * 8);
    }
    mma::cp_async_commit();
  };
  const bool valid0 = gq < nvalid, valid1 = gq + 8 < nvalid;
  float ssum[NT][2], ssq[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) ssum[t][0] = ssum[t][1] = ssq[t][0] = ssq[t][1] = 0.f;
  __syncwarp();
  fetch_x(0);
  for (int hl = 0; hl < nrows; ++hl) {
    if (hl + 1 < nrows) {
      fetch_x(hl + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncwarp();   // row hl has landed for every lane
    bf16* xs = slab + (hl & 1) * 16 * RS;
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float2 bias = *reinterpret_cast<const float2*>(sbp + t * 8 + 2 * q);
      acc[t][0] = acc[t][2] = bias.x;
      acc[t][1] = acc[t][3] = bias.y;
    }
    // pointwise: z (16 x C) . Wp (C x C). z = act(a*x + b) is made on the A
    // fragment of x (its k index is the channel) and split into hi + lo like
    // the constants: x lies on the bf16 grid, so one rounding of z is no
    // random error (at a ~ 1 it rounds most of a*x + b - x away) and shows in
    // the statistics. zh.Wh + zl.Wh + zh.Wl; zl.Wl is below 2^-16.
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t zh[4], zl[4];
      mma::ldmatrix_x4(zh, mma::smem_addr(xs + mma::a_frag_offset(lane, ks * 16, RS)));
      const int c = ks * 16 + 2 * q;
      const float2 a0 = *reinterpret_cast<const float2*>(sa + c);
      const float2 a8 = *reinterpret_cast<const float2*>(sa + c + 8);
      const float2 b0 = *reinterpret_cast<const float2*>(sb + c);
      const float2 b8 = *reinterpret_cast<const float2*>(sb + c + 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = mma::unpack_bf16(zh[r]);
        const float2 av = r < 2 ? a0 : a8, bv = r < 2 ? b0 : b8;
        const float z0 = fno::affine_act_fast(v.x, av.x, bv.x, act);
        const float z1 = fno::affine_act_fast(v.y, av.y, bv.y, act);
        zh[r] = mma::pack_bf16(z0, z1);
        const float2 h = mma::unpack_bf16(zh[r]);
        zl[r] = mma::pack_bf16(z0 - h.x, z1 - h.y);
      }
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        int k, n;
        mma::b_frag_row(lane, ks * 16, np * 16, k, n);
        uint32_t fh[4], fl[4];
        mma::ldmatrix_x4_trans(fh, mma::smem_addr(swp_hi + k * RS + n));
        mma::ldmatrix_x4_trans(fl, mma::smem_addr(swp_lo + k * RS + n));
        mma::mma_bf16(acc[2 * np], zh, fh[0], fh[1]);
        mma::mma_bf16(acc[2 * np + 1], zh, fh[2], fh[3]);
        mma::mma_bf16(acc[2 * np], zl, fh[0], fh[1]);
        mma::mma_bf16(acc[2 * np + 1], zl, fh[2], fh[3]);
        mma::mma_bf16(acc[2 * np], zh, fl[0], fl[1]);
        mma::mma_bf16(acc[2 * np + 1], zh, fl[2], fl[3]);
      }
    }
    // inverse W: [IWr^T | IWi^T] (16 x 2*M3) . [ihr_h ; ihi_h] (2*M3 x C)
    const bf16* ihh = sih + (size_t)hl * 2 * M3 * RS;
#pragma unroll
    for (int ks = 0; ks < KI; ++ks) {
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        int k, n;
        mma::b_frag_row(lane, ks * 16, np * 16, k, n);
        uint32_t fb[4];
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(ihh + k * RS + n));
        mma::mma_bf16(acc[2 * np], iwh[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[2 * np + 1], iwh[ks], fb[2], fb[3]);
        mma::mma_bf16(acc[2 * np], iwl[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[2 * np + 1], iwl[ks], fb[2], fb[3]);
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(ihh + kRows * 2 * M3 * RS + k * RS + n));
        mma::mma_bf16(acc[2 * np], iwh[ks], fb[0], fb[1]);
        mma::mma_bf16(acc[2 * np + 1], iwh[ks], fb[2], fb[3]);
      }
    }
    // statistics from the f32 accumulators, valid columns of W only
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (valid0) {
        ssum[t][0] += acc[t][0];
        ssum[t][1] += acc[t][1];
        ssq[t][0] = fmaf(acc[t][0], acc[t][0], ssq[t][0]);
        ssq[t][1] = fmaf(acc[t][1], acc[t][1], ssq[t][1]);
      }
      if (valid1) {
        ssum[t][0] += acc[t][2];
        ssum[t][1] += acc[t][3];
        ssq[t][0] = fmaf(acc[t][2], acc[t][2], ssq[t][0]);
        ssq[t][1] = fmaf(acc[t][3], acc[t][3], ssq[t][1]);
      }
    }
    // the s tile goes back through the slab (every lane has read its x)
    __syncwarp();
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      bf16* o = xs + gq * RS + t * 8 + 2 * q;
      if (valid0) *reinterpret_cast<uint32_t*>(o) = mma::pack_bf16(acc[t][0], acc[t][1]);
      if (valid1) *reinterpret_cast<uint32_t*>(o + 8 * RS) = mma::pack_bf16(acc[t][2], acc[t][3]);
    }
    __syncwarp();
    bf16* dst = s + rowbase + (size_t)hl * Wp * C;
    for (int i = lane; i < pieces; i += 32) {
      const int r = i / (C / 8), cc = i - r * (C / 8);
      *reinterpret_cast<uint4*>(dst + i * 8) = *reinterpret_cast<const uint4*>(xs + r * RS + cc * 8);
    }
    __syncwarp();   // the slab is free for the copy of row hl + 2
  }

  // ---- the block's partial statistics: lanes of a column pair, then warps, in a fixed order
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = ssum[t][i], w = ssq[t][i];
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
  }
  __syncthreads();
  float* pb = partial + ((size_t)bt * nchunks + chunk) * 2 * C;
  for (int i = tid; i < 2 * C; i += nthreads) {
    float v = 0.f;
    for (int w = 0; w < nwarps; ++w) v += sred[w * 2 * C + i];
    pb[i] = v;
  }
}

int num_chunks(int Hp, int C) { return (Hp + mma_rows(C) - 1) / mma_rows(C); }

template <int C, int KI, int MAXW, int MINB>
cudaError_t launch_k2_mma_as(const void* g, const void* x, const void* a, const void* b,
                             const void* wp, const void* bp, const void* ah, const void* iw,
                             void* s, void* partial, void* stats, int BT, int Hp, int Wp,
                             int m2x2, int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  const MmaLayout L = mma_layout(C, KI * 8, m2x2, warps);
  auto kernel = k2_mma_kernel<C, KI, MAXW, MINB>;
  cudaError_t err = fno::allow_smem(kernel, (size_t)L.total);
  if (err != cudaSuccess) return err;
  // as much of the SM's memory as shared memory as it takes to hold MINB blocks
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_chunks(Hp, C), BT);
  kernel<<<grid, warps * 32, L.total, stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(wp),
      static_cast<const float*>(bp), static_cast<const bf16*>(ah),
      static_cast<const bf16*>(iw), static_cast<bf16*>(s), static_cast<float*>(partial), L, Hp,
      Wp, m2x2, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(stats),
                              BT * num_chunks(Hp, C), 2 * C, stream);
}

cudaError_t launch_k2_mma(const void* g, const void* x, const void* a, const void* b,
                          const void* wp, const void* bp, const void* ah, const void* iw,
                          void* s, void* partial, void* stats, int BT, int Hp, int Wp, int C,
                          int m2x2, int m3, int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  if (warps > kMaxWarps || 2 * m2x2 > 16 * kMaxKH || C % 4 || BT > 65535 || ah == nullptr ||
      iw == nullptr)
    return cudaErrorInvalidValue;
  for (const void* p : {g, x, (const void*)s, ah, iw})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
#define K2_MMA(CC, KK, MW, MB)                                                              \
  if (C == CC && m3 == KK * 8 && warps <= MW)                                               \
  return launch_k2_mma_as<CC, KK, MW, MB>(g, x, a, b, wp, bp, ah, iw, s, partial, stats, BT, \
                                          Hp, Wp, m2x2, act, stream)
  K2_MMA(64, 2, 9, 2);   // the cylinder configuration: two blocks an SM
  K2_MMA(32, 1, 16, 1);
  K2_MMA(32, 2, 16, 1);
  K2_MMA(64, 1, 16, 1);
  K2_MMA(64, 2, 16, 1);
  K2_MMA(128, 1, 9, 1);   // 9 warps leave a thread the registers its 64 accumulators need
  K2_MMA(128, 2, 9, 1);
#undef K2_MMA
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The tf32 variant
// ---------------------------------------------------------------------------

using fno_tf32::kTPad;
constexpr int kXC = 16;   // channels of x a ring stage holds

// Byte offsets of a tf32 block's shared memory (ops/kernels.py::
// k2_tf32_smem_bytes computes the same total). The ring region holds the
// warps' g rings during the H stage, then Wp^T hi and lo and the x rings.
struct Tf32Layout {
  int ih, ring, vec, red, total;
};

inline Tf32Layout tf32_layout(int C, int m3, int m2x2, int warps) {
  Tf32Layout L;
  const int main = 2 * C * (C + kTPad) * 4 + warps * 2 * 16 * (kXC + kTPad) * 4;
  const int gring = warps * fno_tf32::h_ring_floats(m2x2) * 4;
  L.ih = 0;                                               // [rows][C][2*m3 + kTPad]
  L.ring = L.ih + mma_rows(C) * C * (2 * m3 + kTPad) * 4;
  L.vec = L.ring + (main > gring ? main : gring);
  L.red = L.vec + 3 * C * 4;
  L.total = L.red + warps * 2 * C * 4;
  return L;
}

// C channels, KI = m3/8, at most MAXW warps with MINB blocks an SM.
//   s[w, :] = bp + z_h[w, :] . Wp + [IWr^T | IWi^T][w, :] . ih_h
// ah: f32 [nchunks][16][Kpad] (the mma variant's inverse-H rows, Kpad a
// multiple of 8); iw: f32 [16 * warps][2*m3], row w = [iwr[:, w] | iwi[:, w]].
template <int C, int KI, int MAXW, int MINB>
__global__ void __launch_bounds__(MAXW * 32, MINB)
    k2_tf32_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ wp, const float* __restrict__ bp,
                   const float* __restrict__ ah, const float* __restrict__ iw,
                   float* __restrict__ s, float* __restrict__ partial, Tf32Layout L, int Hp,
                   int Wp, int m2x2, int act) {
  constexpr int M3 = KI * 8;
  constexpr int K3 = 2 * M3;          // depth of the inverse-W product: (re | im, m)
  constexpr int kRows = mma_rows(C);
  constexpr int WS = C + kTPad;       // row stride of Wp^T
  constexpr int IS = K3 + kTPad;      // row stride of ih's [c][k] rows
  constexpr int XS = kXC + kTPad;     // row stride of an x stage
  constexpr int NT = C / 8;
  constexpr int kStages = C / kXC;    // ring stages a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sih = reinterpret_cast<float*>(smem_raw + L.ih);    // [kRows][C][IS]
  float* sring = reinterpret_cast<float*>(smem_raw + L.ring);
  float* swh = sring;            // after the H stage: [C][WS], swh[d][c] = hi(wp[c][d])
  float* swl = swh + C * WS;     // the lo parts
  float* sxr = swl + C * WS;     // the warps' x rings
  float* sa = reinterpret_cast<float*>(smem_raw + L.vec);    // [C] each
  float* sb = sa + C;
  float* sbp = sb + C;
  float* sred = reinterpret_cast<float*>(smem_raw + L.red);  // [warps][2][C]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int chunk = blockIdx.x, bt = blockIdx.y;
  const int h0 = chunk * kRows;
  const int nrows = min(kRows, Hp - h0);

  // ---- constants: a, b, bp
  for (int i = tid; i < C; i += nthreads) {
    sa[i] = a[i];
    sb[i] = b[i];
    sbp[i] = bp[i];
  }

  // ---- inverse H into sih[hl][c][part*M3 + m]
  fno_tf32::h_stage<C, M3, kRows>(g, ah, sih, sring + warp * fno_tf32::h_ring_floats(m2x2), bt,
                                  chunk, m2x2, warp, nwarps, lane);
  __syncthreads();   // sih and the constants are complete; the g rings are free

  // ---- Wp^T as a tf32 pair, transposed and split while staged
  for (int i = tid; i < C * C / 4; i += nthreads) {
    const float4 v = reinterpret_cast<const float4*>(wp)[i];
    const int c = (i * 4) / C, d = (i * 4) % C;
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t hi, lo;
      mma::split_tf32(w[u], hi, lo);
      swh[(d + u) * WS + c] = __uint_as_float(hi);
      swl[(d + u) * WS + c] = __uint_as_float(lo);
    }
  }
  __syncthreads();

  // ---- main loop (tf32): warp = the 16 columns w0.. of every row of the block
  const int w0 = warp * 16;
  const int nvalid = min(16, Wp - w0);
  float* slab = sxr + warp * 2 * 16 * XS;   // [2 stages][16][XS]
  // pad rows of both stages stay zero: no copy touches them
  for (int i = lane; i < 2 * 16 * (kXC / 4); i += 32) {
    const int r = i / (kXC / 4), cc = i - r * (kXC / 4);
    if ((r & 15) >= nvalid)
      *reinterpret_cast<float4*>(slab + r * XS + cc * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // inverse-W A fragments in f32 (split for each row): rows w0.., k = (part, m)
  float iwf[K3 / 8][4];
#pragma unroll
  for (int ks = 0; ks < K3 / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      iwf[ks][r] = iw[(size_t)(w0 + gq + (r & 1) * 8) * K3 + ks * 8 + q + (r >> 1) * 4];
  const size_t rowbase = ((size_t)bt * Hp + h0) * Wp * C + (size_t)w0 * C;
  const int nstages = nrows * kStages;
  auto fetch_x = [&](int i) {   // stage i: row i / kStages, channels (i % kStages) * kXC..
    const int hl = i / kStages, j = i - hl * kStages;
    const float* src = x + rowbase + (size_t)hl * Wp * C + j * kXC;
    float* dst = slab + (i & 1) * 16 * XS;
    for (int e = lane; e < nvalid * (kXC / 4); e += 32) {
      const int r = e / (kXC / 4), cc = e - r * (kXC / 4);
      mma::cp_async_16(dst + r * XS + cc * 4, src + (size_t)r * C + cc * 4);
    }
    mma::cp_async_commit();
  };
  const bool valid0 = gq < nvalid, valid1 = gq + 8 < nvalid;
  fno_tf32::ColumnSums<NT> stats;   // sum and sum of squares
  __syncwarp();
  fetch_x(0);
  for (int hl = 0; hl < nrows; ++hl) {
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float2 bias = *reinterpret_cast<const float2*>(sbp + t * 8 + 2 * q);
      acc[t][0] = acc[t][2] = bias.x;
      acc[t][1] = acc[t][3] = bias.y;
    }
    // pointwise: z (16 x C) . Wp (C x C), z = act(a*x + b) made on the A
    // fragment of x (its k index is the channel) and split there
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      const int i = hl * kStages + j;
      if (i + 1 < nstages) {
        fetch_x(i + 1);
        mma::cp_async_wait<1>();
      } else {
        mma::cp_async_wait<0>();
      }
      __syncwarp();   // stage i has landed for every lane
      const float* xs = slab + (i & 1) * 16 * XS;
#pragma unroll
      for (int ks = 0; ks < kXC / 8; ++ks) {
        uint32_t xr[4], zh[4], zl[4];
        mma::ldmatrix_x4(xr, mma::smem_addr(xs + mma::tf32_a_offset(lane, ks * 8, XS)));
        const int c = j * kXC + ks * 8 + q;   // the channel of a0, a1; c + 4 that of a2, a3
        const float a0 = sa[c], a4 = sa[c + 4], b0 = sb[c], b4 = sb[c + 4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          mma::split_tf32(fno::affine_act_fast(__uint_as_float(xr[r]), r < 2 ? a0 : a4,
                                               r < 2 ? b0 : b4, act),
                          zh[r], zl[r]);
        fno_tf32::bt_product_pair<C, WS>(acc, zh, zl, swh, swl, j * kXC + ks * 8, lane);
      }
      __syncwarp();   // the stage is free for the copy of stage i + 2
    }
    // inverse W: [IWr^T | IWi^T] (16 x K3) . ih_h (K3 x C)
    const float* ihh = sih + (size_t)hl * C * IS;
#pragma unroll
    for (int ks = 0; ks < K3 / 8; ++ks) {
      uint32_t fh[4], fl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) mma::split_tf32(iwf[ks][r], fh[r], fl[r]);
      fno_tf32::bt_product<C, IS>(acc, fh, fl, ihh, ks * 8, lane);
    }
    // the store of s and the statistics from the f32 accumulators, valid
    // columns of W only: four lanes' 8-byte stores fill a 32-byte sector
    float* dst = s + rowbase + (size_t)hl * Wp * C;
    float v[4 * NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float u0 = valid0 ? acc[t][0] : 0.f, u1 = valid0 ? acc[t][1] : 0.f;
      const float u2 = valid1 ? acc[t][2] : 0.f, u3 = valid1 ? acc[t][3] : 0.f;
      if (valid0)
        *reinterpret_cast<float2*>(dst + (size_t)gq * C + t * 8 + 2 * q) = make_float2(u0, u1);
      if (valid1)
        *reinterpret_cast<float2*>(dst + (size_t)(gq + 8) * C + t * 8 + 2 * q) =
            make_float2(u2, u3);
      v[4 * t + 0] = u0 + u2;
      v[4 * t + 1] = u1 + u3;
      v[4 * t + 2] = fmaf(u0, u0, u2 * u2);
      v[4 * t + 3] = fmaf(u1, u1, u3 * u3);
    }
    stats.add(v, lane);
  }

  // ---- the block's partial statistics: the warps' in a fixed order
  stats.store(sred, warp, lane);
  __syncthreads();
  float* pb = partial + ((size_t)bt * gridDim.x + chunk) * 2 * C;
  for (int i = tid; i < 2 * C; i += nthreads) {
    float v = 0.f;
    for (int w = 0; w < nwarps; ++w) v += sred[w * 2 * C + i];
    pb[i] = v;
  }
}

template <int C, int KI, int MAXW, int MINB>
cudaError_t launch_k2_tf32_as(const void* g, const void* x, const void* a, const void* b,
                              const void* wp, const void* bp, const void* ah, const void* iw,
                              void* s, void* partial, void* stats, int BT, int Hp, int Wp,
                              int m2x2, int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  const Tf32Layout L = tf32_layout(C, KI * 8, m2x2, warps);
  auto kernel = k2_tf32_kernel<C, KI, MAXW, MINB>;
  cudaError_t err = fno::allow_smem(kernel, (size_t)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_chunks(Hp, C), BT);
  kernel<<<grid, warps * 32, L.total, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(wp),
      static_cast<const float*>(bp), static_cast<const float*>(ah),
      static_cast<const float*>(iw), static_cast<float*>(s), static_cast<float*>(partial), L,
      Hp, Wp, m2x2, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fno::reduce_partials(static_cast<const float*>(partial), static_cast<float*>(stats),
                              BT * num_chunks(Hp, C), 2 * C, stream);
}

cudaError_t launch_k2_tf32(const void* g, const void* x, const void* a, const void* b,
                           const void* wp, const void* bp, const void* ah, const void* iw,
                           void* s, void* partial, void* stats, int BT, int Hp, int Wp, int C,
                           int m2x2, int m3, int act, cudaStream_t stream) {
  const int warps = (Wp + 15) / 16;
  if (warps > kMaxWarps || 2 * m2x2 > 8 * fno_tf32::kMaxKH || BT > 65535 || ah == nullptr ||
      iw == nullptr)
    return cudaErrorInvalidValue;
  for (const void* p : {g, x, wp, (const void*)s, ah, iw})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
#define K2_TF32(CC, KK, MW, MB)                                                              \
  if (C == CC && m3 == KK * 8 && warps <= MW)                                                \
  return launch_k2_tf32_as<CC, KK, MW, MB>(g, x, a, b, wp, bp, ah, iw, s, partial, stats, BT, \
                                           Hp, Wp, m2x2, act, stream)
  K2_TF32(64, 2, 9, 2);   // the cylinder configuration: two blocks an SM
  K2_TF32(32, 1, 16, 1);
  K2_TF32(32, 2, 16, 1);
  K2_TF32(64, 1, 16, 1);
  K2_TF32(64, 2, 16, 1);
  K2_TF32(128, 1, 9, 1);
  K2_TF32(128, 2, 9, 1);   // fsi
#undef K2_TF32
  return cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 fma, 1 mma, 2 tf32 (ops/kernels.py: VARIANTS["k2"]). The caller
// chooses; a variant that does not take the dtype or shape returns an error.

// Number of [2, C] partials the caller allocates as K2's scratch.
extern "C" int fno_k2_num_partials(int BT, int Hp, int C, int variant) {
  return BT * (variant == 0 ? num_hblocks(Hp, C) : num_chunks(Hp, C));
}

// Bytes of shared memory a block of the mma variant takes.
extern "C" int fno_k2_mma_smem_bytes(int Wp, int C, int m2x2, int m3) {
  return mma_layout(C, m3, m2x2, (Wp + 15) / 16).total;
}

// Bytes of shared memory a block of the tf32 variant takes.
extern "C" int fno_k2_tf32_smem_bytes(int Wp, int C, int m2x2, int m3) {
  return tf32_layout(C, m3, m2x2, (Wp + 15) / 16).total;
}

// ah, iw: the packed bf16 hi/lo tables of the mma variant, or the f32 tables
// of the tf32 variant (null for fma).
extern "C" int fno_k2(const void* g, const void* x, const void* a, const void* b,
                      const void* wp, const void* bp, const void* ihr, const void* ihi,
                      const void* iwr, const void* iwi, const void* ah, const void* iw, void* s,
                      void* partial, void* stats, int BT, int Hp, int Wp, int C, int m2x2,
                      int m3, int act, int variant, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || m2x2 < 1 || m3 < 1 || BT < 1 || Hp < 1 || Wp < 1) return cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != fno::kBF16) return cudaErrorInvalidValue;
    return launch_k2_mma(g, x, a, b, wp, bp, ah, iw, s, partial, stats, BT, Hp, Wp, C, m2x2,
                         m3, act, st);
  }
  if (variant == 2) {
    if (dtype != fno::kF32) return cudaErrorInvalidValue;
    return launch_k2_tf32(g, x, a, b, wp, bp, ah, iw, s, partial, stats, BT, Hp, Wp, C, m2x2,
                          m3, act, st);
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == fno::kF32)
    return launch_k2<float>(g, x, a, b, wp, bp, ihr, ihi, iwr, iwi, s, partial, stats, BT, Hp,
                            Wp, C, m2x2, m3, act, st);
  if (dtype == fno::kBF16)
    return launch_k2<__nv_bfloat16>(g, x, a, b, wp, bp, ihr, ihi, iwr, iwi, s, partial, stats,
                                    BT, Hp, Wp, C, m2x2, m3, act, st);
  return cudaErrorInvalidValue;
}
