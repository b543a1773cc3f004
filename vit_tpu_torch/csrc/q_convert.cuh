// The int8 -> bf16 conversion of a weight box on chip, shared by K17's tile
// (mlp_q_wgmma.cuh) and K9's int8 GEMM phases (stack_wgmma.cuh): TMA stages
// an int8 (K, N) weight box as it lies, and this routine writes it as bf16
// in the layout a bf16 wgmma reads as an MN-major B operand through a
// 128-byte-swizzled descriptor (gemm_wgmma.cuh's W boxes): box p of 64 N
// columns, element (k, n) at p * rows * 128 + k * 128 + (((n / 8) ^ (k % 8))
// * 16) + (n % 8) * 2. Unlike the s8 wgmma of i8_wgmma.cuh, bf16 wgmma
// reads B MN-major, so the box keeps its orientation: no transposition.
//
// The values. Each int8 code q becomes the bf16 of q exactly (|q| <= 128
// needs 8 significant bits, bf16 has 8), in bf16x2 arithmetic: with r the
// low 7 bits of the code and s its sign bit, q = r - 128 s, so a prmt puts
// r into the mantissa of 128.0 (0x4300 | r = 128 + r, exact: 7 mantissa
// bits), another puts s into the exponent of 128.0 (0x4300 | 0x80 s = 128
// or 256), and one bf16x2 subtraction of the two gives q for two codes at
// once (exact: an integer of at most 8 bits). Two LOP3, four prmt and two
// HSUB2 for four codes: no I2F, no fp32 step.
//
// The raw layouts (16-byte chunks of 16 codes, n % 16 == 0 at a chunk):
// - dense: TMA without swizzle writes a box of `cols` int8 columns as rows
//   of `cols` bytes (K17's boxes of 64 columns);
// - swizzled: TMA with the 128-byte swizzle writes a box of 128 int8
//   columns, chunk c of row k at k * 128 + ((c ^ (k % 8)) * 16) (K9's boxes,
//   i8_wgmma.cuh's raw layout).
// A chunk of row k, columns [16c, 16c + 16) of a 64-column box, becomes the
// output chunks 2c and 2c + 1 of that row. Chunk e of a slot goes to a
// thread in this order (chunk_of): 32 consecutive chunks cover an 8-row
// block, and each 8 of them rows r and r ^ 5 of it (4 chunks each). Rows r
// and r ^ 5 differ in bit 0 and bit 2: a dense 64-byte row pair then falls
// in two halves of the 128-byte bank window, a swizzled pair on slots
// (c ^ r) and (c ^ r ^ 5), in opposite halves; the stores land on slots
// (2c) ^ r and (2c) ^ r ^ 5, even against odd. So no load or store phase of
// a warp has a bank conflict (tests/test_torch_q_tiles.py checks the byte
// map, the values and the banks).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vit {
namespace qc {

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Four int8 codes (byte i of w is code i) as four bf16: code 0 in the low
// half of lo, code 1 in its high half, codes 2 and 3 in hi.
__device__ __forceinline__ void cvt4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  constexpr uint32_t kHigh = 0x43434343u;  // the high byte of 128.0
  const uint32_t r = w & 0x7F7F7F7Fu, s = w & 0x80808080u;
  const uint32_t a0 = prmt(r, kHigh, 0x4140), a1 = prmt(r, kHigh, 0x4342);
  const uint32_t b0 = prmt(s, kHigh, 0x4140), b1 = prmt(s, kHigh, 0x4342);
  const __nv_bfloat162 d0 =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a0),
              *reinterpret_cast<const __nv_bfloat162*>(&b0));
  const __nv_bfloat162 d1 =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a1),
              *reinterpret_cast<const __nv_bfloat162*>(&b1));
  lo = *reinterpret_cast<const uint32_t*>(&d0);
  hi = *reinterpret_cast<const uint32_t*>(&d1);
}

// 16 codes as two 16-byte chunks of bf16 (codes 0-7, then 8-15).
__device__ __forceinline__ void cvt16(const uint4& r, uint4& o0, uint4& o1) {
  cvt4(r.x, o0.x, o0.y);
  cvt4(r.y, o0.z, o0.w);
  cvt4(r.z, o1.x, o1.y);
  cvt4(r.w, o1.z, o1.w);
}

// The shared address of output chunk j (8 columns) of row k of a bf16
// MN-major box at `box` (128-byte swizzle).
__device__ __forceinline__ uint32_t mn_chunk(uint32_t box, int k, int j) {
  return box + k * 128 + ((j ^ (k & 7)) << 4);
}

// The shared address of raw chunk c of row k: dense rows of `row_bytes`,
// or the 128-byte swizzle of a 128-column box.
__device__ __forceinline__ uint32_t raw_dense(uint32_t raw, int k, int c,
                                              int row_bytes) {
  return raw + k * row_bytes + (c << 4);
}
__device__ __forceinline__ uint32_t raw_sw128(uint32_t raw, int k, int c) {
  return raw + k * 128 + ((c ^ (k & 7)) << 4);
}

__device__ __forceinline__ uint4 ld_shared4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Chunk e of a slot of 64-column boxes of `rows` rows (a multiple of 8):
// its box, row and column chunk (the header comment's order).
__device__ __forceinline__ void chunk_of(int e, int rows, int& box, int& k,
                                         int& c) {
  const int ell = e & 31;
  const int row = (e >> 5) * 8 + ((ell >> 3) ^ (((ell >> 2) & 1) * 5));
  box = row / rows;
  k = row % rows;
  c = ell & 3;
}

// Convert raw chunk (k, c) of a 64-column box, held in r, into the bf16
// box at `box`.
__device__ __forceinline__ void store_chunk(uint32_t box, int k, int c,
                                            const uint4& r) {
  uint4 o0, o1;
  cvt16(r, o0, o1);
  st_shared4(mn_chunk(box, k, 2 * c), o0);
  st_shared4(mn_chunk(box, k, 2 * c + 1), o1);
}

}  // namespace qc
}  // namespace vit
