// The truncated (W, H) DFT of a [Hp, Wp, 16-channel slice] f32 image on the
// tensor cores as 3xTF32, shared by K1's tf32 variant (fno_k1.cu: the
// forward DFT of z = act(a*x + b)) and K2A-lite's (fno_k2a.cu: the adjoint
// of K2's inverse DFT applied to ds). It is fno_dft_mma.cuh's body with f32
// operands, on the same tables in f32 (ops/fno_layer.py::_wh_mma_tables):
//
//   W: X_h = EW (2*m3 x Wp) . v_h (Wp x 16), EW rows (re|im, m)
//   H: Y   = sum over h of EH_h ((re|im, j) x (re|im, r)) . X_h
//
// and the same epilogue interface (epi.stage, then epi(acc, ...) on the
// accumulators of Y): K1 stores y (dftmma::StoreY in f32), K2A-lite adds
// its mode-space correction.
// Every product is hi.hi + hi.lo + lo.hi on mma.sync m16n8k8 (mma.cuh), each
// f32 operand split into its tf32 pair in registers, f32 accumulators.
//
// A block owns one bt and a 16-channel slice, 8 warps; the rows of H go in
// chunks of 8, warp r taking row 8*chunk + r. What differs from the bf16
// body:
//   - The ring. In f32 a two-stage ring of whole rows takes 147 KB a block
//     (8 warps x 2 x 144 x 16 x 4 B), one block an SM. Each warp's ring here
//     holds pieces of kPiece = 32 rows of W (a row is ceil(Wp/32) pieces,
//     consumed in order, the next one in flight, the next row's first piece
//     behind the last): 4 KB a warp. Rows are 16 floats, the two 8-channel
//     halves swapped on bit 1 of w (ring_at), so that the 32-bit loads of
//     the B fragments (k = w, n = c) fall on 32 banks; ldmatrix.trans moves
//     b16 only and gives no tf32 fragment. A piece's rows past Wp read
//     whatever finite row the ring holds (zeroed at the start) and meet zero
//     columns of EW.
//   - EW is split once when the block stages it: hi and lo, [2*m3][KW8 + 4]
//     f32 each (KW8 = Wp rounded up to 8), A fragments by ldmatrix (rows 16
//     bytes apart mod 128). EH's fragments come from the table in global
//     memory, split in registers, as the bf16 body reads them.
//   - X_h stays f32 (the one rounding of the W product's sum), in two
//     [16][m3*16 + 8] tiles; the H fold reads its [k][n] B fragments by
//     32-bit loads (a row stride of 8 mod 32 floats: 32 banks) and splits
//     them.
//   - With kAffine the affine and the activation act on the W product's B
//     values in f32 (the exact GELU through fno::erf_fast), then the split.
// Shared memory at m3 16, Wp 134: 102528 bytes (EW's pair 35840, the X
// tiles 33792, the rings 32768), two blocks (16 warps) an SM.
#pragma once

#include <cstdint>

#include "fno_common.cuh"
#include "fno_dft_mma.cuh"
#include "mma.cuh"

namespace dfttf32 {

using dftmma::kSlice;        // channels a block takes
using dftmma::kWarps;        // rows of H a chunk takes, one a warp
constexpr int kPiece = 32;   // rows of W a ring stage holds
constexpr int kEPad = 4;     // f32 padding of EW's rows (ldmatrix: 16 bytes apart mod 128)
constexpr int kXPad = 8;     // f32 padding of an X tile's rows (32-bit loads on 32 banks)

__host__ __device__ constexpr int kw8(int Wp) { return (Wp + 7) / 8 * 8; }

// Bytes of shared memory the body takes (ops/kernels.py::k1_tf32_smem_bytes):
// EW hi and lo [2*m3][KW8 + kEPad], two X tiles [16][m3*16 + kXPad], the
// warps' rings [2][kPiece][16], a and b of the slice (all f32). An
// epilogue's own shared memory follows.
inline int body_smem(int Wp, int m3) {
  return 2 * 2 * m3 * (kw8(Wp) + kEPad) * 4 + 2 * 16 * (m3 * kSlice + kXPad) * 4 +
         kWarps * 2 * kPiece * kSlice * 4 + 2 * kSlice * 4;
}

// Float offset, in a warp's ring stage, of channel c of row w: the 8-channel
// halves swap on bit 1 of w, so that the lanes (q, g) of a B fragment's
// load, rows k0 + q (+4) and channel g (or 8 + g), hit 32 distinct banks.
__device__ __forceinline__ int ring_at(int w, int c) {
  return w * kSlice + (c ^ (((w >> 1) & 1) << 3));
}

// M3 W modes; MTH 16-row tiles of the H product's (re|im, j) rows. The
// epilogue is called as in fno_dft_mma.cuh: epi.stage(smem, tid) before the
// block's first barrier, epi(acc, bt, c0, warp, lane) at the end, acc[mt][t]
// holding rows R = mt*16 + (lane>>2) (+8) = (re|im, j) and columns
// n = warp*2*M3 + t*8 + 2*(lane&3) (+1) = (m, c) of Y. ew: [2*M3][KW16] f32
// (KW16 = Wp rounded up to 16); eh: [nchunks][MTH*16][16] f32.
template <int M3, int MTH, bool kAffine, typename Epi>
__device__ __forceinline__ void wh_tf32_body(const float* __restrict__ x,
                                             const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             const float* __restrict__ ew,
                                             const float* __restrict__ eh, const Epi& epi,
                                             int Hp, int Wp, int C, int act) {
  constexpr int MTW = M3 / 8;              // 16-row tiles of the W product's (re|im, m) rows
  constexpr int XN = M3 * kSlice;          // columns (m, c) of an X tile
  constexpr int XS = XN + kXPad;           // its row stride
  constexpr int NTH = 2 * M3 / 8;          // a warp's 8-column tiles of the H product
  constexpr int RING = kPiece * kSlice;    // floats of a ring stage
  const int KW = kw8(Wp), ES = KW + kEPad, KWT = (Wp + 15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sewh = reinterpret_cast<float*>(smem_raw);   // [2*M3][ES]: rows (re|im, m), columns w
  float* sewl = sewh + 2 * M3 * ES;
  float* sx = sewl + 2 * M3 * ES;                      // [2][16][XS]: rows (re|im, r), columns (m, c)
  float* sring = sx + 2 * 16 * XS;                     // [warps][2][kPiece][16], ring_at layout
  float* sab = sring + kWarps * 2 * RING;              // a, b [16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kSlice, bt = blockIdx.y;
  const int nch = (Hp + kWarps - 1) / kWarps;
  const int npc = (Wp + kPiece - 1) / kPiece;   // ring pieces a row

  // EW as its tf32 pair, split once
  for (int i = tid; i < 2 * M3 * (KW / 4); i += blockDim.x) {
    const int r = i / (KW / 4), cc = i - r * (KW / 4);
    const float4 v = *reinterpret_cast<const float4*>(ew + (size_t)r * KWT + cc * 4);
    const float w[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) mma::split_tf32(w[u], hi[u], lo[u]);
    *reinterpret_cast<uint4*>(sewh + r * ES + cc * 4) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(sewl + r * ES + cc * 4) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  for (int i = tid; i < 2 * 16 * XS / 4; i += blockDim.x)
    reinterpret_cast<float4*>(sx)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kAffine && tid < kSlice) {
    sab[tid] = a[c0 + tid];
    sab[kSlice + tid] = b[c0 + tid];
  }
  epi.stage(reinterpret_cast<unsigned char*>(sab + 2 * kSlice), tid);
  float* ring = sring + warp * 2 * RING;
  // the warp's own ring starts at zero: a piece's rows past Wp read finite values
  for (int i = lane; i < 2 * RING / 4; i += 32)
    reinterpret_cast<float4*>(ring)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  const float* xb = x + (size_t)bt * Hp * Wp * C + c0;
  auto fetch = [&](int h, int p, int stage) {   // piece p of row h: rows w0.. of W
    const int w0 = p * kPiece, len = min(kPiece, Wp - w0);
    const float* src = xb + ((size_t)h * Wp + w0) * C;
    float* dst = ring + stage * RING;
    for (int i = lane; i < 4 * len; i += 32)
      mma::cp_async_16(dst + ring_at(i >> 2, 4 * (i & 3)), src + (size_t)(i >> 2) * C + 4 * (i & 3));
    mma::cp_async_commit();
  };
  if (warp < Hp) fetch(warp, 0, 0);
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

  int seq = 0;   // pieces this warp has taken: piece seq sits in stage seq & 1
  for (int ch = 0; ch < nch; ++ch) {
    const int h = ch * kWarps + warp;
    float* xt = sx + (ch & 1) * 16 * XS;
    if (h < Hp) {
      float xa[MTW][2][4];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t) xa[mt][t][0] = xa[mt][t][1] = xa[mt][t][2] = xa[mt][t][3] = 0.f;
      for (int p = 0; p < npc; ++p, ++seq) {
        const bool last = p + 1 == npc;   // then the next piece is the next row's first
        if (!last || h + kWarps < Hp) {
          fetch(last ? h + kWarps : h, last ? 0 : p + 1, (seq + 1) & 1);
          mma::cp_async_wait<1>();
        } else {
          mma::cp_async_wait<0>();
        }
        __syncwarp();   // piece seq has landed for every lane
        const float* rs = ring + (seq & 1) * RING;
        const int w0 = p * kPiece, nks = (min(kPiece, Wp - w0) + 7) / 8;
        for (int ks = 0; ks < nks; ++ks) {   // W product
          // B: v[w0 + ks*8 + q (+4)][c], c = gq (+8); the affine and the
          // activation in f32, then the split
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float v = rs[ring_at(ks * 8 + q + 4 * r, t * 8 + gq)];
              if (kAffine) v = fno::affine_act_fast(v, av[t], bv[t], act);
              mma::split_tf32(v, bh[t][r], bl[t][r]);
            }
#pragma unroll
          for (int mt = 0; mt < MTW; ++mt) {
            uint32_t fh[4], fl[4];
            const int off = mt * 16 * ES + mma::tf32_a_offset(lane, w0 + ks * 8, ES);
            mma::ldmatrix_x4(fh, mma::smem_addr(sewh + off));
            mma::ldmatrix_x4(fl, mma::smem_addr(sewl + off));
#pragma unroll
            for (int t = 0; t < 2; ++t)
              mma::mma_tf32x3(xa[mt][t], fh, fl, bh[t][0], bh[t][1], bl[t][0], bl[t][1]);
          }
        }
        __syncwarp();   // the stage is free for the piece after next
      }
      // X_h into rows (re|im, warp) of the tile: accumulator row R = (part, m)
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int R = mt * 16 + gq + hf * 8, part = R / M3, m = R - part * M3;
            *reinterpret_cast<float2*>(xt + (part * 8 + warp) * XS + m * kSlice + t * 8 + 2 * q) =
                make_float2(xa[mt][t][2 * hf], xa[mt][t][2 * hf + 1]);
          }
    } else {   // a row past Hp: its X rows are zero (EH is zero there too)
      for (int i = lane; i < 2 * XN / 4; i += 32) {
        const int part = i / (XN / 4), cc = i - part * (XN / 4);
        *reinterpret_cast<float4*>(xt + (part * 8 + warp) * XS + cc * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();   // the chunk's X tile is complete
    // H fold: acc += EH_chunk (MTH*16 x 16) . X tile (16 x this warp's 2*M3
    // columns), k = (re|im, r) in two steps of 8
    const float* ehc = eh + (size_t)ch * MTH * 16 * 16;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {   // H fold
      uint32_t bh[NTH][2], bl[NTH][2];
#pragma unroll
      for (int t = 0; t < NTH; ++t) {
        const float* col = xt + (ks * 8 + q) * XS + warp * 2 * M3 + t * 8 + gq;
        mma::split_tf32(col[0], bh[t][0], bl[t][0]);
        mma::split_tf32(col[4 * XS], bh[t][1], bl[t][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MTH; ++mt) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          mma::split_tf32(__ldg(ehc + (mt * 16 + gq + (r & 1) * 8) * 16 + ks * 8 + q + (r >> 1) * 4),
                          ah[r], al[r]);
#pragma unroll
        for (int t = 0; t < NTH; ++t)
          mma::mma_tf32x3(acc[mt][t], ah, al, bh[t][0], bh[t][1], bl[t][0], bl[t][1]);
      }
    }
    // no barrier here: the next chunk writes the other tile, which every warp
    // finished reading before it reached this chunk's barrier
  }
  epi(acc, bt, c0, warp, lane);
}

}  // namespace dfttf32
