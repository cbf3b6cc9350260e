// Tensor-core building blocks shared by the kernels: warp-level bf16 MMA
// (mma.sync m16n8k16, f32 accumulate) with its ldmatrix operand loads, the
// cp.async copies a shared-memory ring is made of, and the hi + lo split
// that carries an f32 constant through two bf16 products; the tf32 MMA
// (m16n8k8) and the tf32 hi + lo split that carries an f32 operand through
// three of them (3xTF32).
//
// Fragment layout of mma.sync.m16n8k16 (row.col), lane = 4*g + q:
//   A (16 x 16, 4 regs)  a0 (row g,   k 2q, 2q+1)   a1 (row g+8, k 2q, 2q+1)
//                        a2 (row g,   k 2q+8, +9)   a3 (row g+8, k 2q+8, +9)
//   B (16 x 8, 2 regs)   b0 (k 2q, 2q+1, col g)     b1 (k 2q+8, +9, col g)
//   C (16 x 8, 4 f32)    c0, c1 (row g, col 2q, 2q+1)   c2, c3 (row g+8, ...)
// A register holds two bf16 values, the lower index in the lower half.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l passes the address of row l%8 of matrix l/8.
// With a row-major [m][k] tile and the addresses of a_frag_offset this is an
// A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, each matrix transposed on the way: from a row-major [k][n] tile
// and the addresses of b_frag_row, the B fragments of two neighbouring
// 8-column tiles: (r0, r1) for columns n0..n0+7, (r2, r3) for n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Element offset, in a row-major [16][stride] tile starting at column k0, of
// the row this lane names to ldmatrix_x4 for an A fragment.
__device__ __forceinline__ int a_frag_offset(int lane, int k0, int stride) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + k0 + (lane >> 4) * 8;
}

// (k, n) of the row this lane names to ldmatrix_x4_trans for the B fragments
// of the 16 x 16 block at (k0, n0) of a row-major [k][n] tile.
__device__ __forceinline__ void b_frag_row(int lane, int k0, int n0, int& k, int& n) {
  k = k0 + ((lane >> 3) & 1) * 8 + (lane & 7);
  n = n0 + (lane >> 4) * 8;
}

// (n, k) of the row this lane names to ldmatrix_x4 (not transposed) for the
// B fragments of the 16 x 16 block at (k0, n0) of a row-major [n][k] tile
// (B stored as its transpose): (r0, r1) for columns n0..n0+7, (r2, r3) for
// n0+8..n0+15, as ldmatrix_x4_trans gives them from a [k][n] tile.
__device__ __forceinline__ void bt_frag_row(int lane, int k0, int n0, int& n, int& k) {
  n = n0 + (lane >> 4) * 8 + (lane & 7);
  k = k0 + ((lane >> 3) & 1) * 8;
}

// (k, m) of the row this lane names to ldmatrix_x4_trans for an A fragment
// of the 16 x 16 block at (m0, k0) of a row-major [k][m] tile (the
// transpose of the A operand is what is stored): matrix l/8 covers m0 +
// 8*(l/8 % 2), k0 + 8*(l/16).
__device__ __forceinline__ void at_frag_row(int lane, int k0, int m0, int& k, int& m) {
  k = k0 + (lane >> 4) * 8 + (lane & 7);
  m = m0 + ((lane >> 3) & 1) * 8;
}

// d += a (16x16 bf16) * b (16x8 bf16), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned), past L1.
__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// v = hi + lo with both parts bf16: hi = rn(v), lo = rn(v - hi). The sum
// carries 16 mantissa bits (relative error <= 2^-17), so a constant that
// multiplies every position can go through two bf16 MMAs without a
// systematic error in sums over the positions. The host-side twin is
// ops/kernels.py::split_bf16.
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// The (hi, lo) split of a pair of floats, each part packed as one register
// of two bf16 (v0 in the lower half): an MMA operand pair.
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// ---------------------------------------------------------------------------
// tf32 (3xTF32: f32 operands through the tensor cores)
//
// Fragment layout of mma.sync.m16n8k8 (row.col, .tf32), lane = 4*g + q, one
// element a register:
//   A (16 x 8, 4 regs)   a0 (row g, k q)   a1 (row g+8, k q)
//                        a2 (row g, k q+4) a3 (row g+8, k q+4)
//   B (8 x 8, 2 regs)    b0 (k q, col g)   b1 (k q+4, col g)
//   C (16 x 8, 4 f32)    as the bf16 MMA's.
// ldmatrix moves b16 elements: on an f32 tile read as b16 pairs (offsets in
// f32 elements, rows 16 bytes = 4 floats) ldmatrix_x4 does give the A
// fragment of a row-major [16][8] tile (tf32_a_offset) and the B fragments
// of an [n][k] tile (tf32_bt_row); ldmatrix_x4_trans gives no tf32
// fragment, so a [k][n] tile is read with 32-bit (or, with the k order
// permuted alike in A and B, 64-bit) shared loads instead.
// ---------------------------------------------------------------------------

// d += a (16x8 tf32) * b (8x8 tf32), f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to tf32 (10 mantissa bits; to nearest, ties away from zero), as
// the bits of an f32 whose low 13 mantissa bits are zero: the half unit of
// the last kept bit added to the bits, the rest cut. For finite v these are
// cvt_tf32's bits, at two integer operations where the cvt issues at a
// quarter of their rate. A NaN whose top mantissa bits are all set (the
// canonical 0x7fffffff) carries into the sign and comes out as +-0.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// The same rounding by cvt.rna.tf32.f32, which keeps Inf and NaN.
__device__ __forceinline__ uint32_t cvt_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo with both parts tf32: hi = rna(v), lo = rna(v - hi). The sum
// carries 22 mantissa bits (relative error <= 2^-22), so hi.hi + hi.lo +
// lo.hi, three tf32 MMAs, is an f32 product to ~2^-21 of the sum of
// |terms|. hi by to_tf32, lo by cvt_tf32: where v is Inf or NaN, v - hi is
// NaN, so lo is NaN and so is every 3xTF32 product it enters. On an H100
// (tools/torch_k3b_probe.py) K3B's tf32 variant takes 10.9 ms so; 7.6 with
// lo by to_tf32 as well (a NaN lost), 14.0 with both by cvt_tf32, 17.7 with
// to_tf32 testing for Inf and NaN, 12.8 with lo's NaN kept by an FMA. The
// host-side twin is ops/kernels.py::split_tf32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = cvt_tf32(v - __uint_as_float(hi));
}

// The split of each register of a fragment (f32 bits in, tf32 pairs out).
template <int N>
__device__ __forceinline__ void split_frag(const uint32_t (&v)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(v[i]), hi[i], lo[i]);
}

// d += (ah + al)(bh + bl) without al.bl: three tf32 MMAs, the small terms
// first.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// f32 element offset, in a row-major [16][stride] f32 tile (stride a
// multiple of 4) starting at column k0, of the row this lane names to
// ldmatrix_x4 for the tf32 A fragment of columns k0..k0+7.
__device__ __forceinline__ int tf32_a_offset(int lane, int k0, int stride) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + k0 + (lane >> 4) * 4;
}

// (n, k) of the row this lane names to ldmatrix_x4 for the tf32 B fragments
// of the 8 x 16 block at (k0, n0) of a row-major [n][k] f32 tile (B stored
// as its transpose): (r0, r1) = (b0, b1) for columns n0..n0+7, (r2, r3) for
// n0+8..n0+15.
__device__ __forceinline__ void tf32_bt_row(int lane, int k0, int n0, int& n, int& k) {
  n = n0 + (lane >> 4) * 8 + (lane & 7);
  k = k0 + ((lane >> 3) & 1) * 4;
}

}  // namespace mma
