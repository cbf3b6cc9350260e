// K1 of the fused FNO layer: z = act(a*x + b), then the truncated forward
// DFT of z over W (m3 rfft modes) and over H (2*m2 kept modes).
//
// Replaces realpdebench_tpu/ops/pallas/fno_layer.py::_k1_kernel.
//
//   x  [BT, Hp, Wp, C]  (T)     activations, channels minor
//   a, b [C]            (f32)   previous layer's folded BatchNorm
//   ewr, ewi [Wp, m3]   (f32)   forward W DFT (cos, -sin)
//   ehr, ehi [Hp, 2m2]  (f32)   forward H DFT on the kept modes
//   y  [BT, 2m2*m3, 2C] (T)     rows (j2, m), lanes (re | im, c)
//
// What bounds it on an H100: bytes. At rollout width (BT 208, Hp 70, Wp 134,
// C 64, m3 16, 2*m2 24) a launch reads 250 MB of x and writes 20 MB of y
// (0.081 ms at 3.35 TB/s); its 10.9 GFLOP (8 in the W contraction, 3 in the
// H fold) take 0.011 ms on the tensor cores, but 0.16 ms at the FP32 peak,
// and the first version, on FP32 FMAs with both operands of every FMA from
// shared memory, ran at 3% of the bound.
//
// Two variants, chosen from dtype, shape and alignment before the launch
// (ops/kernels.py::k1_variant):
//
//  * mma (bf16; C a multiple of 16, m3 in {8, 16}, 2*m2 <= 32, Wp <= 256,
//    16-byte aligned x): both contractions on mma.sync m16n8k16 (mma.cuh),
//    f32 accumulators. A block owns one bt and a 16-channel slice, 8 warps;
//    the rows of H go in chunks of 8, warp r taking row 8*chunk + r.
//      - W: X_h = EW (2*m3 x Wp) . z_h (Wp x 16), EW = [ewr^T ; ewi^T] in
//        shared memory (A, ldmatrix), z_h the warp's own row of x, brought in
//        by 16-byte cp.async into a two-stage per-warp ring (the next row's
//        copy overlaps this one's products), read with ldmatrix.trans as B;
//        the affine and the activation act on the B fragment, whose column
//        (the channel) is fixed per lane. The ring's rows are 32 bytes, the
//        two 16-byte halves swapped on bit 2 of w so that ldmatrix reads
//        without bank conflicts; rows past Wp hold zeros and meet zero
//        columns of EW.
//      - H: each warp writes X_h, rounded to bf16, into row (re|im, r) of a
//        [16, m3*16] tile; after one block barrier a chunk's fold is
//        Y += EH_chunk ((re|im, j) x (re|im, r)) . X_tile, the block's
//        (re|im, j) x (m, c) accumulators spread over the warps (2*m3
//        columns each), EH_chunk's fragments read from a packed table. Two
//        tiles alternate, so one barrier a chunk suffices.
//      - Rounding: z, the DFT factors and X are bf16 operands, once each,
//        as JAX's _dot rounds both operands of each of K1's products to
//        bf16 (ops/pallas/fno_layer.py:292-303); the sums are f32 and y
//        rounds once on the write. Nothing of K1 feeds an f32 sum the port
//        holds to 1e-4 (its output is rounded to bf16), so no operand needs
//        the hi + lo pair that K2 and K12B take.
//    Shared memory at m3 16, Wp 134: 100 KB, two blocks (16 warps) an SM.
//  * fma (f32 tensors, other shapes): one block per (bt, 16-channel slice);
//    thread (c, m) owns one W mode of one channel. For each row h the block
//    stages z[h, :, slice] in shared memory, each thread contracts it against
//    its W-mode column and folds the result into its 2*m2 complex H-mode
//    accumulators (registers). x is read once, y written once; exact f32.
#include <cstdint>
#include <initializer_list>

#include "fno_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxJ2 = 32;  // 2*m2 upper bound: the H accumulators live in registers

template <typename T>
__global__ void k1_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ b, const float* __restrict__ ewr,
                          const float* __restrict__ ewi, const float* __restrict__ ehr,
                          const float* __restrict__ ehi, T* __restrict__ y, int Hp, int Wp,
                          int C, int m2x2, int m3, int act) {
  extern __shared__ float smem[];
  const int CT = blockDim.x;
  const int nthr = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * CT + threadIdx.x;
  float* zrow = smem;              // [Wp][CT]
  float* sw_r = zrow + Wp * CT;    // [Wp][m3]
  float* sw_i = sw_r + Wp * m3;
  float* sh_r = sw_i + Wp * m3;    // [Hp][m2x2]
  float* sh_i = sh_r + Hp * m2x2;
  float* sa = sh_i + Hp * m2x2;    // [CT]
  float* sb = sa + CT;

  const int bt = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  for (int i = tid; i < Wp * m3; i += nthr) {
    sw_r[i] = ewr[i];
    sw_i[i] = ewi[i];
  }
  for (int i = tid; i < Hp * m2x2; i += nthr) {
    sh_r[i] = ehr[i];
    sh_i[i] = ehi[i];
  }
  for (int i = tid; i < CT; i += nthr) {
    sa[i] = a[c0 + i];
    sb[i] = b[c0 + i];
  }

  const int cl = threadIdx.x;
  const int m = threadIdx.y;
  float acc_r[kMaxJ2], acc_i[kMaxJ2];
#pragma unroll
  for (int j = 0; j < kMaxJ2; ++j) {
    acc_r[j] = 0.f;
    acc_i[j] = 0.f;
  }
  const T* xb = x + (size_t)bt * Hp * Wp * C + c0;
  for (int h = 0; h < Hp; ++h) {
    __syncthreads();  // constants staged; the previous row is consumed
    const T* xh = xb + (size_t)h * Wp * C;
    for (int i = tid; i < Wp * CT; i += nthr) {
      const int w = i / CT;
      const int cc = i - w * CT;
      zrow[i] = fno::affine_act(fno::to_f32(xh[(size_t)w * C + cc]), sa[cc], sb[cc], act);
    }
    __syncthreads();
    float sr = 0.f, si = 0.f;
    for (int w = 0; w < Wp; ++w) {
      const float z = zrow[w * CT + cl];
      sr = fmaf(z, sw_r[w * m3 + m], sr);
      si = fmaf(z, sw_i[w * m3 + m], si);
    }
#pragma unroll
    for (int j = 0; j < kMaxJ2; ++j) {
      if (j < m2x2) {
        const float er = sh_r[h * m2x2 + j];
        const float ei = sh_i[h * m2x2 + j];
        acc_r[j] = fmaf(sr, er, fmaf(-si, ei, acc_r[j]));
        acc_i[j] = fmaf(sr, ei, fmaf(si, er, acc_i[j]));
      }
    }
  }
  T* yb = y + (size_t)bt * m2x2 * m3 * 2 * C + c0 + cl;
#pragma unroll
  for (int j = 0; j < kMaxJ2; ++j) {
    if (j < m2x2) {
      T* row = yb + (size_t)(j * m3 + m) * 2 * C;
      row[0] = fno::from_f32<T>(acc_r[j]);
      row[C] = fno::from_f32<T>(acc_i[j]);
    }
  }
}

template <typename T>
cudaError_t launch_k1(const void* x, const void* a, const void* b, const void* ewr,
                      const void* ewi, const void* ehr, const void* ehi, void* y, int BT,
                      int Hp, int Wp, int C, int m2x2, int m3, int act, cudaStream_t stream) {
  const int CT = C < 16 ? C : 16;
  if (C % CT != 0 || m2x2 > kMaxJ2 || m2x2 < 1 || m3 < 1 || CT * m3 > 1024)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)Wp * CT + 2 * (size_t)Wp * m3 +
                                       2 * (size_t)Hp * m2x2 + 2 * (size_t)CT);
  cudaError_t err = fno::allow_smem(k1_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BT, C / CT);
  const dim3 block(CT, m3);
  k1_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(ewr), static_cast<const float*>(ewi),
      static_cast<const float*>(ehr), static_cast<const float*>(ehi), static_cast<T*>(y), Hp,
      Wp, C, m2x2, m3, act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core variant
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;   // rows of H a chunk takes, one a warp
constexpr int kSlice = 16;     // channels a block takes

__host__ __device__ constexpr int k1_kw(int Wp) { return (Wp + 15) / 16 * 16; }

// Bytes of shared memory of a block (ops/kernels.py::k1_mma_smem_bytes): EW
// [2*m3][KW + 8], two X tiles [16][m3*16 + 8] (bf16), the warps' rings
// [2][KW][16] (bf16), a and b of the slice.
inline int k1_mma_smem(int Wp, int m3) {
  const int kw = k1_kw(Wp);
  return 2 * m3 * (kw + 8) * 2 + 2 * 16 * (m3 * kSlice + 8) * 2 + kMmaWarps * 2 * kw * kSlice * 2 +
         2 * kSlice * 4;
}

// Element offset, in a warp's ring stage, of the 16-byte half `half` of row w:
// the halves swap on bit 2 of w, so the 8 rows an ldmatrix reads fall on 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int ring_at(int w, int half) {
  return w * kSlice + ((half ^ ((w >> 2) & 1)) << 3);
}

// M3 W modes; MTH 16-row tiles of the H product's (re|im, j) rows.
template <int M3, int MTH>
__global__ void __launch_bounds__(kMmaWarps * 32, 2)
    k1_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                  const float* __restrict__ b, const bf16* __restrict__ ew,
                  const bf16* __restrict__ eh, bf16* __restrict__ y, int Hp, int Wp, int C,
                  int m2x2, int act) {
  constexpr int MTW = M3 / 8;              // 16-row tiles of the W product's (re|im, m) rows
  constexpr int XN = M3 * kSlice;          // columns (m, c) of an X tile
  constexpr int XS = XN + 8;               // its row stride (bank spread)
  constexpr int NTH = 2 * M3 / 8;          // a warp's 8-column tiles of the H product
  const int KW = k1_kw(Wp), ES = KW + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sew = reinterpret_cast<bf16*>(smem_raw);   // [2*M3][ES]: rows (re|im, m), columns w
  bf16* sx = sew + 2 * M3 * ES;                    // [2][16][XS]: rows (re|im, r), columns (m, c)
  bf16* sring = sx + 2 * 16 * XS;                  // [warps][2][KW][16], ring_at layout
  float* sab = reinterpret_cast<float*>(sring + kMmaWarps * 2 * KW * kSlice);   // a, b [16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kSlice, bt = blockIdx.y;
  const int nch = (Hp + kMmaWarps - 1) / kMmaWarps;

  for (int i = tid; i < 2 * M3 * (KW / 8); i += blockDim.x) {
    const int r = i / (KW / 8), cc = i - r * (KW / 8);
    *reinterpret_cast<uint4*>(sew + r * ES + cc * 8) = reinterpret_cast<const uint4*>(ew)[i];
  }
  for (int i = tid; i < 2 * 16 * XS / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(sx)[i] = make_uint4(0, 0, 0, 0);
  if (tid < kSlice) {
    sab[tid] = a[c0 + tid];
    sab[kSlice + tid] = b[c0 + tid];
  }
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
  __syncthreads();   // EW, a, b and the zeroed X tiles are in place

  // the B fragment's channel of this lane, per 8-column tile: gq, 8 + gq
  const float av[2] = {sab[gq], sab[8 + gq]}, bv[2] = {sab[kSlice + gq], sab[kSlice + 8 + gq]};
  float acc[MTH][NTH][4];
#pragma unroll
  for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
    for (int t = 0; t < NTH; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    const int h = ch * kMmaWarps + warp, stage = ch & 1;
    bf16* xt = sx + stage * 16 * XS;
    if (h < Hp) {
      if (h + kMmaWarps < Hp) {
        fetch(h + kMmaWarps, stage ^ 1);
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
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = mma::unpack_bf16(fb[r]);
          const int t = r >> 1;
          fb[r] = mma::pack_bf16(fno::affine_act_fast(v.x, av[t], bv[t], act),
                                 fno::affine_act_fast(v.y, av[t], bv[t], act));
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

  // y[bt][(j, m)][part*C + c0 + c] from the accumulator rows (part, j), columns (m, c)
  bf16* yb = y + (size_t)bt * m2x2 * M3 * 2 * C + c0;
#pragma unroll
  for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
    for (int t = 0; t < NTH; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int R = mt * 16 + gq + hf * 8;
        if (R >= 2 * m2x2) continue;
        const int part = R / m2x2, j = R - part * m2x2;
        const int n = warp * 2 * M3 + t * 8 + 2 * q, m = n / kSlice, c = n - m * kSlice;
        *reinterpret_cast<uint32_t*>(yb + (size_t)(j * M3 + m) * 2 * C + part * C + c) =
            mma::pack_bf16(acc[mt][t][2 * hf], acc[mt][t][2 * hf + 1]);
      }
}

template <int M3, int MTH>
cudaError_t launch_k1_mma_as(const void* x, const void* a, const void* b, const void* ew,
                             const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2,
                             int act, cudaStream_t stream) {
  auto kernel = k1_mma_kernel<M3, MTH>;
  const int smem = k1_mma_smem(Wp, M3);
  cudaError_t err = fno::allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(C / kSlice, BT), kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(ew), static_cast<const bf16*>(eh), static_cast<bf16*>(y), Hp, Wp,
      C, m2x2, act);
  return cudaGetLastError();
}

cudaError_t launch_k1_mma(const void* x, const void* a, const void* b, const void* ew,
                          const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2,
                          int m3, int act, cudaStream_t stream) {
  if (C % kSlice || m2x2 < 1 || m2x2 > 32 || Wp > 256 || BT > 65535 || ew == nullptr ||
      eh == nullptr || k1_mma_smem(Wp, m3) > 232448)
    return cudaErrorInvalidValue;
  for (const void* p : {x, ew, eh, (const void*)y})
    if ((uintptr_t)p % 16) return cudaErrorMisalignedAddress;
  const int mth = (2 * m2x2 + 15) / 16;
#define K1_MMA(MM, MT)                                                                        \
  if (m3 == MM && mth == MT)                                                                  \
  return launch_k1_mma_as<MM, MT>(x, a, b, ew, eh, y, BT, Hp, Wp, C, m2x2, act, stream)
  K1_MMA(16, 3);   // the cylinder: 2*m2 = 24
  K1_MMA(16, 4);   // fsi, combustion: 2*m2 = 32
  K1_MMA(16, 1);
  K1_MMA(16, 2);
  K1_MMA(8, 1);
  K1_MMA(8, 2);
  K1_MMA(8, 3);
  K1_MMA(8, 4);
#undef K1_MMA
  return cudaErrorInvalidValue;
}

}  // namespace

// Text of a cudaError_t code returned by any entry point of the library.
extern "C" const char* fno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of shared memory a block of the mma variant takes.
extern "C" int fno_k1_mma_smem_bytes(int Wp, int m3) { return k1_mma_smem(Wp, m3); }

// variant: 0 fma, 1 mma (ops/kernels.py: VARIANTS["k1"]); ew, eh: the packed
// bf16 DFT tables of the mma variant (null for fma).
extern "C" int fno_k1(const void* x, const void* a, const void* b, const void* ewr,
                      const void* ewi, const void* ehr, const void* ehi, const void* ew,
                      const void* eh, void* y, int BT, int Hp, int Wp, int C, int m2x2, int m3,
                      int act, int variant, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BT < 1 || Hp < 1 || Wp < 1 || C < 1 || m3 < 1) return cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != fno::kBF16) return cudaErrorInvalidValue;
    return launch_k1_mma(x, a, b, ew, eh, y, BT, Hp, Wp, C, m2x2, m3, act, s);
  }
  if (variant != 0) return cudaErrorInvalidValue;
  if (dtype == fno::kF32)
    return launch_k1<float>(x, a, b, ewr, ewi, ehr, ehi, y, BT, Hp, Wp, C, m2x2, m3, act, s);
  if (dtype == fno::kBF16)
    return launch_k1<__nv_bfloat16>(x, a, b, ewr, ewi, ehr, ehi, y, BT, Hp, Wp, C, m2x2, m3,
                                    act, s);
  return cudaErrorInvalidValue;
}
