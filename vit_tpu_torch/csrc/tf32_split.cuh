// The three-pass TF32 split on Hopper's tensor cores, the fp32 forms' way to
// the tensor cores (K2's tile, gemm_tf32.cuh; K13's, flash_attention_bwd.cu).
//
// Why a split. The JAX kernels run their fp32 dots at Precision.HIGHEST
// (vit_tpu/ops/pallas/matmul.py:37-45), which the TPU's MXU gives as
// several bf16 passes. One TF32 pass keeps 11 significant bits of each
// operand and would break the golden bar. So each fp32 operand is split,
//   x = hi + lo,  hi = tf32(x),  lo = x - hi (read by the tensor cores as
//   tf32, its low 13 bits ignored),
// tf32() rounding to the nearest tf32 value (ties away from zero, as
// cvt.rna), and a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b,
// three passes into one fp32 accumulator, the small terms first. x - hi is
// exact in fp32; lo keeps the next 11 bits, so each operand carries about
// 22 bits and each product of tf32 values is exact in fp32 (22 significant
// bits). What is lost is lo_a lo_b (2^-22 of the product) and lo's
// truncation (under 2^-21 of x, unbiased): about fp32's rounding of the
// 24-bit operands.
// tests/test_torch_fp32_split.py models it in PyTorch bit for bit up to
// the sum order; vit_tpu_torch/tools/tf32_probe.py measured it on the card
// (PERF.md, section 6).
//
// The rates (NVIDIA's data sheet, H100 SXM, dense): TF32 495 TFLOP/s, so
// three passes about 165, against 67 for fp32 on FFMA.

#pragma once

#include <stdint.h>

namespace vit {

// tf32(x): x rounded to 10 stored mantissa bits, to nearest, ties away
// from zero (cvt.rna.tf32.f32's rounding); the low 13 bits of the result
// are zero. Two integer operations: cvt runs at a sixteenth of their rate
// on this card, and the split runs once for every operand element a
// product reads.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo as the tensor cores take them (tf32 in 32-bit registers): lo
// = x - hi exactly in fp32, passed as it is; a tf32 product ignores an
// operand's low 13 bits, so the tensor cores read lo truncated to tf32
// (within 2^-10 of lo, 2^-21 of x; its sign follows x - hi, so the error
// has no bias).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on the tensor cores, one pass: a 16 x 8 tf32 A fragment, an
// 8 x 8 tf32 B fragment (two registers), a 16 x 8 fp32 accumulator. With
// g = lane / 4 and t = lane % 4 a lane holds a[0] = A(g, t), a[1] = A(g+8,
// t), a[2] = A(g, t+4), a[3] = A(g+8, t+4); b0 = B(t, g), b1 = B(t+4, g);
// d[0], d[1] = D(g, 2t), D(g, 2t+1), d[2], d[3] = D(g+8, 2t), D(g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three passes: lo_a hi_b, hi_a lo_b, hi_a hi_b.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

#define VIT_TF8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VIT_TF64(d, i)                                                  \
  VIT_TF8(d, i), VIT_TF8(d, i + 8), VIT_TF8(d, i + 16), VIT_TF8(d, i + 24), \
      VIT_TF8(d, i + 32), VIT_TF8(d, i + 40), VIT_TF8(d, i + 48),       \
      VIT_TF8(d, i + 56)

// d (64 x 128 over a warpgroup) = [d +] A (64 x 8, tf32, in registers) @
// B (8 x 128, tf32, K-major in shared memory through descriptor db), one
// pass: wgmma.mma_async m64n128k8. tf32 wgmma takes B K-major only (the
// transpose bits exist for 16-bit types alone). A is the warp's 16 rows in
// mma_tf32's fragment layout; d is the accumulator layout of
// gemm_wgmma.cuh's epilogue (value 4j + i: row 16 warp + g + 8 (i / 2),
// column 8j + 2t + i % 2). accumulate 0: d = A B.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : VIT_TF64(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// wgmma_tf32's narrower forms, m64n64k8 and m64n32k8 (K13's tiles), always
// accumulating: d (64 x N over a warpgroup) += A (64 x 8) @ B (8 x N).
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : VIT_TF8(d, 0), VIT_TF8(d, 8), VIT_TF8(d, 16), VIT_TF8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : VIT_TF8(d, 0), VIT_TF8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef VIT_TF64
#undef VIT_TF8

// Byte offset of fp32 element (r, c) of a 128-byte-swizzled tile of rows of
// 32 floats: row r at 128 r, its 16-byte chunk c / 4 XORed with r % 8 (the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and the wgmma
// descriptors read).
__host__ __device__ __forceinline__ uint32_t sw128_f32(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((((c >> 2) ^ r) & 7) << 4) +
                               ((c & 3) << 2));
}

}  // namespace vit
