// The parts K2's and K12B's tf32 variants share (fno_k2.cu, fno_k12b.cu):
// every product on the tensor cores as 3xTF32 (mma.cuh: each f32 operand
// split into a tf32 hi + lo pair in registers, hi.hi + hi.lo + lo.hi on
// mma.sync m16n8k8, f32 accumulators), each f32 operand stored once in
// shared memory.
//
//  * h_stage: the H stage both kernels open with (K2's inverse H DFT,
//    K12B's adjoint of K1's forward one), the block's rows of
//      out[hl][c][part*M3 + m] = sum_k T[(part, hl)][k] * G[k][(m, c)],
//    k = (p', j), G[(p', j)][(m, c)] = in[bt][j*M3 + m][p'*C + c]; T is the
//    block's [16][Kpad] f32 tile of the host table (row r < rows: real part
//    of row hl = r, row 8 + r its imaginary part), held in registers as tf32
//    pairs. A warp takes the 8-channel pieces (m, c0..c0+7) in turn, each
//    through its own two-stage cp.async ring of [K][8] f32 tiles, read with
//    32-bit shared loads (a [k][n] tile: no ldmatrix; a row stride of 8
//    floats puts the 32 lanes on 32 banks). The result lands in shared
//    memory as [hl][c][k], the [n][k] layout the main product reads its B
//    fragments from by ldmatrix.
//  * bt_product: acc (16 x C) += A (16 x 8, a tf32 pair) . B (8 x C), B's
//    fragments read by ldmatrix from an [n][k] f32 tile and split in
//    registers; bt_product_pair, the same from a pair of [n][k] tiles
//    split once when staged (Wp's).
//  * ColumnSums: per-column sums of a warp's rows (K2's statistics, the dz
//    pass's da and db) held as four running sums a lane, not 4*C/8.
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace fno_tf32 {

constexpr int kTPad = 4;    // f32 padding of a row read by ldmatrix: rows 16 bytes apart mod 128
constexpr int kGC = 8;      // channels of g / dy a warp stages at a time: one 8-column tile
constexpr int kMaxKH = 8;   // k-steps of the H product: 2 * (2*m2) <= 64

// Floats of a warp's two-stage ring over g / dy.
__host__ __device__ constexpr int h_ring_floats(int m2x2) { return 2 * (2 * m2x2) * kGC; }

// The H stage of one warp (see the header); the caller ends it with
// __syncthreads(). ring: this warp's h_ring_floats(m2x2) floats.
template <int C, int M3, int kRows>
__device__ __forceinline__ void h_stage(const float* __restrict__ in, const float* __restrict__ table,
                                        float* __restrict__ out, float* __restrict__ ring, int bt,
                                        int chunk, int m2x2, int warp, int nwarps, int lane) {
  constexpr int IS = 2 * M3 + kTPad;          // row stride of out's [c][k] rows
  constexpr int kPieces = M3 * (C / kGC);
  const int gq = lane >> 2, q = lane & 3;
  const int K = 2 * m2x2;
  const int ksteps = (K + 7) / 8, Kpad = ksteps * 8;
  const float* gb = in + (size_t)bt * m2x2 * M3 * 2 * C;
  const float* tb = table + (size_t)chunk * 16 * Kpad;
  auto fetch = [&](int p, int stage) {
    const int m = p / (C / kGC), c0 = (p - m * (C / kGC)) * kGC;
    float* dst = ring + stage * K * kGC;
    for (int i = lane; i < 2 * K; i += 32) {
      const int k = i >> 1, half = i & 1;
      const int pp = k / m2x2, j = k - pp * m2x2;
      mma::cp_async_16(dst + k * kGC + half * 4,
                       gb + ((size_t)(j * M3 + m) * 2 * C + pp * C + c0 + half * 4));
    }
    mma::cp_async_commit();
  };
  if (warp < kPieces) fetch(warp, 0);
  // the block's constant A fragments, split once, while the first piece flies
  uint32_t th[kMaxKH][4], tl[kMaxKH][4];
#pragma unroll
  for (int ks = 0; ks < kMaxKH; ++ks) {
    if (ks >= ksteps) break;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      mma::split_tf32(tb[(gq + (r & 1) * 8) * Kpad + ks * 8 + q + (r >> 1) * 4], th[ks][r],
                      tl[ks][r]);
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
    const float* gs = ring + stage * K * kGC;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kMaxKH; ++ks) {
      if (ks >= ksteps) break;
      // b0 = G[k][c0 + gq], b1 = G[k + 4][c0 + gq]; past K the table is zero
      // and any finite row serves
      const int k0 = ks * 8 + q, k1 = k0 + 4;
      uint32_t bh0, bl0, bh1, bl1;
      mma::split_tf32(gs[(k0 < K ? k0 : 0) * kGC + gq], bh0, bl0);
      mma::split_tf32(gs[(k1 < K ? k1 : 0) * kGC + gq], bh1, bl1);
      mma::mma_tf32x3(acc, th[ks], tl[ks], bh0, bh1, bl0, bl1);
    }
    __syncwarp();   // the stage is free for the piece after next
    if (gq < kRows) {
      // accumulator rows: gq is (re, hl = gq), gq + 8 is (im, hl = gq);
      // columns c0 + 2q, c0 + 2q + 1
      const int m = p / (C / kGC), c0 = (p - m * (C / kGC)) * kGC;
      float* o = out + ((size_t)gq * C + c0 + 2 * q) * IS + m;
      o[0] = acc[0];
      o[IS] = acc[1];
      o[M3] = acc[2];
      o[IS + M3] = acc[3];
    }
  }
}

// acc[0 .. C/8) (16 x C) += A (16 x 8 at k0, the pair ah + al) . B, B's rows
// k0..k0+7 read from the [n][k] f32 tile bt (row stride BS) and split.
template <int C, int BS>
__device__ __forceinline__ void bt_product(float (&acc)[C / 8][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const float* bt, int k0,
                                           int lane) {
#pragma unroll
  for (int np = 0; np < C / 16; ++np) {
    int n, k;
    mma::tf32_bt_row(lane, k0, np * 16, n, k);
    uint32_t fb[4], fh[4], fl[4];
    mma::ldmatrix_x4(fb, mma::smem_addr(bt + n * BS + k));
    mma::split_frag(fb, fh, fl);
    mma::mma_tf32x3(acc[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
    mma::mma_tf32x3(acc[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);
  }
}

// The same from the pair of tf32 tiles bh (hi), bl (lo), split when staged.
template <int C, int BS>
__device__ __forceinline__ void bt_product_pair(float (&acc)[C / 8][4],
                                                const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4], const float* bh,
                                                const float* bl, int k0, int lane) {
#pragma unroll
  for (int np = 0; np < C / 16; ++np) {
    int n, k;
    mma::tf32_bt_row(lane, k0, np * 16, n, k);
    uint32_t fh[4], fl[4];
    mma::ldmatrix_x4(fh, mma::smem_addr(bh + n * BS + k));
    mma::ldmatrix_x4(fl, mma::smem_addr(bl + n * BS + k));
    mma::mma_tf32x3(acc[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
    mma::mma_tf32x3(acc[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);
  }
}

// Per-column sums of a warp's rows without 4*C/8 running sums a lane (96
// registers a thread at two blocks of 9 warps an SM). A row's 4 values a
// tile t, index 4t + 2w + i for the sums u (w = 0) and w (w = 1) of
// columns t*8 + 2q + i, are added over the 8 lanes of a column pair and
// scattered at once, in a fixed order: three shuffle stages, each lane
// keeping half of what is left while more than one tile is; lane (g, q)
// then adds into its kSums running sums the values from first(lane) on.
template <int NT>
struct ColumnSums {
  static constexpr int N = 4 * NT;
  static constexpr int n1 = N > 4 ? N / 2 : N, n2 = n1 > 4 ? n1 / 2 : n1;
  static constexpr int kSums = n2 > 4 ? n2 / 2 : n2;   // the sums a lane keeps
  float sum[kSums];

  __device__ __forceinline__ ColumnSums() {
#pragma unroll
    for (int j = 0; j < kSums; ++j) sum[j] = 0.f;
  }

  template <int n>
  static __device__ __forceinline__ void stage(float (&v)[N], int off, int lane) {
    if constexpr (n > 4) {
      const bool up = lane & off;
#pragma unroll
      for (int j = 0; j < n / 2; ++j) {
        const float keep = up ? v[j + n / 2] : v[j], send = up ? v[j] : v[j + n / 2];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    } else {
#pragma unroll
      for (int j = 0; j < n; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
  }

  // add one row's values (v is consumed)
  __device__ __forceinline__ void add(float (&v)[N], int lane) {
    stage<N>(v, 16, lane);
    stage<n1>(v, 8, lane);
    stage<n2>(v, 4, lane);
#pragma unroll
    for (int j = 0; j < kSums; ++j) sum[j] += v[j];
  }

  // index (4t + ...) of this lane's first sum
  static __device__ __forceinline__ int first(int lane) {
    return ((lane & 16) && N > 4 ? N / 2 : 0) + ((lane & 8) && n1 > 4 ? n1 / 2 : 0) +
           ((lane & 4) && n2 > 4 ? n2 / 2 : 0);
  }

  // the warp's sums into sred[(warp * 2 + 0 / 1) * C + column] (u, then w)
  __device__ __forceinline__ void store(float* sred, int warp, int lane) const {
    constexpr int C = NT * 8;
    const int q = lane & 3, base = first(lane);
#pragma unroll
    for (int j = 0; j < kSums; ++j) {
      const int idx = base + j, t = idx >> 2, e = idx & 3;
      sred[(warp * 2 + (e >> 1)) * C + t * 8 + 2 * q + (e & 1)] = sum[j];
    }
  }
};

}  // namespace fno_tf32
