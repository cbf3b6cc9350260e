// The truncated (W, H) DFT of a [Hp, Wp, 16-channel slice] image on the
// tensor cores, shared by K1's mma variant (fno_k1.cu: the forward DFT of
// z = act(a*x + b)) and K2A-lite's (fno_k2a.cu: the adjoint of K2's inverse
// DFT applied to ds). Both are the same two products on different tables:
//
//   W: X_h = EW (2*m3 x Wp) . v_h (Wp x 16), EW rows (re|im, m)
//   H: Y   = sum over h of EH_h ((re|im, j) x (re|im, r)) . X_h
//
// (ops/fno_layer.py::_wh_mma_tables packs EW and EH for either map). The
// body leaves Y in its accumulators and hands them to an epilogue, which
// writes them: K1 stores y, K2A-lite adds its mode-space correction first.
//
// A block owns one bt and a 16-channel slice, 8 warps; the rows of H go in
// chunks of 8, warp r taking row 8*chunk + r.
//   - W: v_h, the warp's own row of the input, comes by 16-byte cp.async into
//     a two-stage per-warp ring (the next row's copy overlaps this one's
//     products) and is read with ldmatrix.trans as B; with kAffine the affine
//     and the activation act on the B fragment, whose column (the channel)
//     is fixed per lane. The ring's rows are 32 bytes, the two 16-byte
//     halves swapped on bit 2 of w so that ldmatrix reads without bank
//     conflicts; rows past Wp hold zeros and meet zero columns of EW.
//   - H: each warp writes X_h, rounded to bf16, into row (re|im, r) of a
//     [16, m3*16] tile; after one block barrier a chunk's fold is
//     Y += EH_chunk . X_tile, the block's (re|im, j) x (m, c) accumulators
//     spread over the warps (2*m3 columns each), EH_chunk's fragments read
//     from the packed table. Two tiles alternate, so one barrier a chunk.
//   - Rounding: the input, the tables and X are bf16 operands, once each,
//     as JAX's _dot rounds both operands of each product to bf16
//     (ops/pallas/fno_layer.py:292-303); the sums are f32.
#pragma once

#include <cstdint>

#include "fno_common.cuh"
#include "mma.cuh"

namespace dftmma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;    // rows of H a chunk takes, one a warp
constexpr int kSlice = 16;   // channels a block takes

__host__ __device__ constexpr int kw_of(int Wp) { return (Wp + 15) / 16 * 16; }

// Bytes of shared memory the body takes (ops/kernels.py::k1_mma_smem_bytes):
// EW [2*m3][KW + 8], two X tiles [16][m3*16 + 8] (bf16), the warps' rings
// [2][KW][16] (bf16), a and b of the slice. An epilogue's own shared memory
// follows.
inline int body_smem(int Wp, int m3) {
  const int kw = kw_of(Wp);
  return 2 * m3 * (kw + 8) * 2 + 2 * 16 * (m3 * kSlice + 8) * 2 + kWarps * 2 * kw * kSlice * 2 +
         2 * kSlice * 4;
}

// Element offset, in a warp's ring stage, of the 16-byte half `half` of row w:
// the halves swap on bit 2 of w, so the 8 rows an ldmatrix reads fall on 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int ring_at(int w, int half) {
  return w * kSlice + ((half ^ ((w >> 2) & 1)) << 3);
}

// M3 W modes; MTH 16-row tiles of the H product's (re|im, j) rows. The
// epilogue is called as epi.stage(smem, tid) before the block's first
// barrier (to stage its own constants after the body's shared memory) and
// as epi(acc, bt, c0, warp, lane) at the end, acc[mt][t] holding rows
// R = mt*16 + (lane>>2) (+8) = (re|im, j) and columns
// n = warp*2*M3 + t*8 + 2*(lane&3) (+1) = (m, c) of Y.
template <int M3, int MTH, bool kAffine, typename Epi>
__device__ __forceinline__ void wh_mma_body(const bf16* __restrict__ x,
                                            const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            const bf16* __restrict__ ew,
                                            const bf16* __restrict__ eh, const Epi& epi, int Hp,
                                            int Wp, int C, int m2x2, int act) {
  constexpr int MTW = M3 / 8;              // 16-row tiles of the W product's (re|im, m) rows
  constexpr int XN = M3 * kSlice;          // columns (m, c) of an X tile
  constexpr int XS = XN + 8;               // its row stride (bank spread)
  constexpr int NTH = 2 * M3 / 8;          // a warp's 8-column tiles of the H product
  const int KW = kw_of(Wp), ES = KW + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sew = reinterpret_cast<bf16*>(smem_raw);   // [2*M3][ES]: rows (re|im, m), columns w
  bf16* sx = sew + 2 * M3 * ES;                    // [2][16][XS]: rows (re|im, r), columns (m, c)
  bf16* sring = sx + 2 * 16 * XS;                  // [warps][2][KW][16], ring_at layout
  float* sab = reinterpret_cast<float*>(sring + kWarps * 2 * KW * kSlice);   // a, b [16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kSlice, bt = blockIdx.y;
  const int nch = (Hp + kWarps - 1) / kWarps;

  for (int i = tid; i < 2 * M3 * (KW / 8); i += blockDim.x) {
    const int r = i / (KW / 8), cc = i - r * (KW / 8);
    *reinterpret_cast<uint4*>(sew + r * ES + cc * 8) = reinterpret_cast<const uint4*>(ew)[i];
  }
  for (int i = tid; i < 2 * 16 * XS / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(sx)[i] = make_uint4(0, 0, 0, 0);
  if (kAffine && tid < kSlice) {
    sab[tid] = a[c0 + tid];
    sab[kSlice + tid] = b[c0 + tid];
  }
  epi.stage(reinterpret_cast<unsigned char*>(sab + 2 * kSlice), tid);
  bf16* ring = sring + warp * 2 * KW * kSlice;
  // rows past Wp of both stages stay zero: no copy touches them
  for (int i = lane; i < 2 * (KW - Wp) * 2; i += 32) {
    const int st = i / ((KW - Wp) * 2), rem = i - st * (KW - Wp) * 2;
    *reinterpret_cast<uint4*>(ring + st * KW * kSlice + ring_at(Wp + (rem >> 1), rem & 1)) =
        make_uint4(0, 0, 0, 0);
  }
  const bf16* xb = x + (size_t)bt * Hp * Wp * C + c0;
  auto fetch = [&](int h, int stage) {
    const bf16* src = xb + (size_t)h * Wp * C;
    bf16* dst = ring + stage * KW * kSlice;
    for (int i = lane; i < 2 * Wp; i += 32)
      mma::cp_async_16(dst + ring_at(i >> 1, i & 1), src + (size_t)(i >> 1) * C + (i & 1) * 8);
    mma::cp_async_commit();
  };
  if (warp < Hp) fetch(warp, 0);
  __syncthreads();   // EW, a, b, the epilogue's constants and the zeroed X tiles are in place

  // the B fragment's channel of this lane, per 8-column tile: gq, 8 + gq
  float av[2] = {1.f, 1.f}, bv[2] = {0.f, 0.f};
  if (kAffine) {
    av[0] = sab[gq];
    av[1] = sab[8 + gq];
    bv[0] = sab[kSlice + gq];
    bv[1] = sab[kSlice + 8 + gq];
  }
  float acc[MTH][NTH][4];
#pragma unroll
  for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
    for (int t = 0; t < NTH; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    const int h = ch * kWarps + warp, stage = ch & 1;
    bf16* xt = sx + stage * 16 * XS;
    if (h < Hp) {
      if (h + kWarps < Hp) {
        fetch(h + kWarps, stage ^ 1);
        mma::cp_async_wait<1>();
      } else {
        mma::cp_async_wait<0>();
      }
      __syncwarp();   // row h has landed for every lane
      const bf16* rs = ring + stage * KW * kSlice;
      float xa[MTW][2][4];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t) xa[mt][t][0] = xa[mt][t][1] = xa[mt][t][2] = xa[mt][t][3] = 0.f;
      for (int ks = 0; ks < KW / 16; ++ks) {
        const int k = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        uint32_t fb[4];
        mma::ldmatrix_x4_trans(fb, mma::smem_addr(rs + ring_at(k, lane >> 4)));
        if (kAffine) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = mma::unpack_bf16(fb[r]);
            const int t = r >> 1;
            fb[r] = mma::pack_bf16(fno::affine_act_fast(v.x, av[t], bv[t], act),
                                   fno::affine_act_fast(v.y, av[t], bv[t], act));
          }
        }
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          uint32_t fa[4];
          mma::ldmatrix_x4(fa, mma::smem_addr(sew + mt * 16 * ES + mma::a_frag_offset(lane, ks * 16, ES)));
          mma::mma_bf16(xa[mt][0], fa, fb[0], fb[1]);
          mma::mma_bf16(xa[mt][1], fa, fb[2], fb[3]);
        }
      }
      __syncwarp();   // the stage is free for the row after next
      // X_h into rows (re|im, warp) of the tile: accumulator row R = (part, m)
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int R = mt * 16 + gq + hf * 8, part = R / M3, m = R - part * M3;
            *reinterpret_cast<uint32_t*>(xt + (part * 8 + warp) * XS + m * kSlice + t * 8 + 2 * q) =
                mma::pack_bf16(xa[mt][t][2 * hf], xa[mt][t][2 * hf + 1]);
          }
    } else {   // a row past Hp: its X rows are zero (EH is zero there too)
      for (int i = lane; i < 2 * XN / 8; i += 32) {
        const int part = i / (XN / 8), cc = i - part * (XN / 8);
        *reinterpret_cast<uint4*>(xt + (part * 8 + warp) * XS + cc * 8) = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();   // the chunk's X tile is complete
    // H fold: acc += EH_chunk (MTH*16 x 16) . X tile (16 x this warp's 2*M3 columns)
    const bf16* ehc = eh + (size_t)ch * MTH * 16 * 16;
    uint32_t fa[MTH][4];
#pragma unroll
    for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        fa[mt][r] = *reinterpret_cast<const uint32_t*>(
            ehc + (mt * 16 + gq + (r & 1) * 8) * 16 + 2 * q + (r >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NTH / 2; ++np) {
      int k, n;
      mma::b_frag_row(lane, 0, warp * 2 * M3 + np * 16, k, n);
      uint32_t fb[4];
      mma::ldmatrix_x4_trans(fb, mma::smem_addr(xt + k * XS + n));
#pragma unroll
      for (int mt = 0; mt < MTH; ++mt) {
        mma::mma_bf16(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
        mma::mma_bf16(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
      }
    }
    // no barrier here: the next chunk writes the other tile, which every warp
    // finished reading before it reached this chunk's barrier
  }
  epi(acc, bt, c0, warp, lane);
}

// Two neighbouring outputs: rounded to bf16 (the mma bodies), or in f32
// (the tf32 ones).
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = mma::pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The plain epilogue (K1) of both bodies: y[bt][(j, m)][part*C + c0 + c]
// from the accumulator rows (part, j), columns (m, c), in T.
template <int M3, int MTH, typename T>
struct StoreY {
  T* __restrict__ y;
  int C, m2x2;
  __device__ __forceinline__ void stage(unsigned char*, int) const {}
  __device__ __forceinline__ void operator()(const float (&acc)[MTH][2 * M3 / 8][4], int bt,
                                             int c0, int warp, int lane) const {
    const int gq = lane >> 2, q = lane & 3;
    T* yb = y + (size_t)bt * m2x2 * M3 * 2 * C + c0;
#pragma unroll
    for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
      for (int t = 0; t < 2 * M3 / 8; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int R = mt * 16 + gq + hf * 8;
          if (R >= 2 * m2x2) continue;
          const int part = R / m2x2, j = R - part * m2x2;
          const int n = warp * 2 * M3 + t * 8 + 2 * q, m = n / kSlice, c = n - m * kSlice;
          store_pair(yb + (size_t)(j * M3 + m) * 2 * C + part * C + c, acc[mt][t][2 * hf],
                     acc[mt][t][2 * hf + 1]);
        }
  }
};

}  // namespace dftmma
