// The int8 tier's pieces for Hopper's tensor cores, shared by K11's tile
// (matmul_i8_wgmma.cu) and K12's (mlp_i8_wgmma.cuh): s8 x s8 -> s32
// wgmma.mma_async (m64nNk32), and the routine that turns a weight box
// K-major on chip. The mbarrier, TMA, descriptor and bounded-wait helpers
// are gemm_wgmma.cuh's (K2's), used from there.
//
// Why a transposition. For 8-bit inputs wgmma reads both operands K-major
// only: the transpose bits that let K2 and K3 read W where it lies exist
// for f16/bf16 alone. The int8 weights arrive as JAX gives them, q (K, N)
// row-major, which is N-major, and the port keeps that layout: no
// transposed copy in the parameters, no transpose launch. The activations
// (xq, the quantized context, K12's hq) are K-major already.
//
// So the producer side stages an N-major box of W by TMA
// (CU_TENSOR_MAP_DATA_TYPE_UINT8, 128-byte swizzle) and writes it
// transposed into the K-major layout the s8 descriptor reads:
//
// - a raw box is 128 K rows x 128 N bytes; TMA puts byte (k, n) at
//   k*128 + (((n/16) ^ (k%8)) * 16) + n%16;
// - a K-major box is 128 N rows x 128 K bytes, byte (n, k) at
//   n*128 + (((k/16) ^ (n%8)) * 16) + k%16: one 128-byte swizzle row holds
//   128 int8 of K, 8 rows form a 1024-byte atom, so the descriptor's stride
//   between 8-row groups is 1024 bytes and a k32 step moves its start 32
//   bytes (bf16's k16 geometry); a 64-row half (N = 64) starts 8 KB in;
// - the transposition goes in 4 x 4-byte blocks: a thread reads 4 words
//   (4 K rows, 4 N bytes each) with 32-bit shared loads, turns them with 8
//   prmt into 4 words (4 K bytes of one n each) and stores those. Lane l
//   of a warp takes block (k4, n4) = (l ^ d, l) in its pass d (0..31), so
//   that the 32 loads of one instruction fall in 32 banks, and the 32
//   stores too: a load's bank is ((n4/4 ^ (k%8)) * 4 + n4%4) % 32, a
//   store's ((k4/4 ^ (n%8)) * 4 + k4%4) % 32, both bijections of l
//   (tests/test_torch_i8_tiles.py checks the byte map and the banks).
//
// An int8 A operand (64 rows x 128 K bytes, K-major) is the same layout:
// TMA writes it directly from a (M, K) row-major matrix, or a kernel
// writes its codes there itself (K12's xq and hq).

#pragma once

#include "gemm_wgmma.cuh"

namespace vit {
namespace i8 {

using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::sw128_desc;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int kBK = 128;      // K bytes a step: one 128-byte swizzle row
constexpr int kBox = 16384;   // 128 x 128 int8: a raw or K-major box
constexpr int kHalf = 8192;   // 64 rows x 128 bytes: one warpgroup's A
constexpr int kThreads = 384;  // consumers 0-255, producer 256-383
// The producer warpgroup: warp 8 issues TMA (one thread), warps 9-11
// transpose.
constexpr int kTmaThread = 256;
constexpr int kTransposer0 = 288;
constexpr int kTransposers = 96;
// setmaxnreg as in gemm_wgmma.cuh, with room for the transposers' words:
// the launchers refuse a build whose kernel got fewer than kPoolRegs /
// kThreads registers a thread (setmaxnreg.inc would wait forever).
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kPoolRegs = 256 * kConsumerRegs + 128 * kProducerRegs;
static_assert(kPoolRegs <= 65536, "one block an SM: 64K registers");

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The words of block (k4, n4) of a raw box at src, and where output word j
// of it goes in the K-major box at dst (the header comment's byte maps).
__device__ __forceinline__ uint32_t raw_word(uint32_t src, int k4, int n4,
                                             int i) {
  const int k = 4 * k4 + i;
  return src + k * 128 + ((((n4 >> 2) ^ (k & 7)) << 4) | ((n4 & 3) << 2));
}
__device__ __forceinline__ uint32_t kmajor_word(uint32_t dst, int k4, int n4,
                                                int j) {
  const int n = 4 * n4 + j;
  return dst + n * 128 + ((((k4 >> 2) ^ (n & 7)) << 4) | ((k4 & 3) << 2));
}

// Transpose a 4 x 4-byte block: byte i of output word j is byte j of
// input word i.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = prmt(w[0], w[1], 0x5140), t1 = prmt(w[0], w[1], 0x7362);
  const uint32_t t2 = prmt(w[2], w[3], 0x5140), t3 = prmt(w[2], w[3], 0x7362);
  o[0] = prmt(t0, t2, 0x5410);
  o[1] = prmt(t0, t2, 0x7632);
  o[2] = prmt(t1, t3, 0x5410);
  o[3] = prmt(t1, t3, 0x7632);
}

// The raw box at `src` (128 K rows x 128 N bytes as TMA wrote it) into the
// K-major box at `dst` (128 N rows x 128 K bytes), by the kTransposers
// threads, t their index: warp t/32 takes passes d = t/32, t/32 + 3, ...,
// two at a time, both passes' loads issued before either's stores (the
// loads and stores are volatile, so the compiler keeps this order; the two
// boxes do not overlap).
__device__ __forceinline__ void transpose_box(uint32_t src, uint32_t dst,
                                              int t) {
  constexpr int kStep = kTransposers / 32;
  const int lane = t % 32;
  for (int d = t / 32; d < 32; d += 2 * kStep) {
    const bool two = d + kStep < 32;
    uint32_t w[2][4], o[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p == 0 || two)
          w[p][i] = ld_shared(raw_word(src, lane ^ (d + p * kStep), lane, i));
#pragma unroll
    for (int p = 0; p < 2; ++p) transpose4(w[p], o[p]);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p == 0 || two)
          st_shared(kmajor_word(dst, lane ^ (d + p * kStep), lane, j),
                    o[p][j]);
  }
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define VIT_I8_R8(d, i)                                                 \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d = A (64 x 32, K-major) @ B (32 x N, K-major) + (acc ? d : 0), exact
// int32 sums: value 4j + i of a thread is row 16 * warp + lane / 4 +
// 8 * (i / 2), column 8j + 2 * (lane % 4) + i % 2, as for fp32 sums.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : VIT_I8_R8(d, 0), VIT_I8_R8(d, 8), VIT_I8_R8(d, 16), VIT_I8_R8(d, 24)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : VIT_I8_R8(d, 0), VIT_I8_R8(d, 8), VIT_I8_R8(d, 16), VIT_I8_R8(d, 24),
        VIT_I8_R8(d, 32), VIT_I8_R8(d, 40), VIT_I8_R8(d, 48), VIT_I8_R8(d, 56)
      : "l"(da), "l"(db), "r"(acc));
}

#undef VIT_I8_R8

// The descriptor of a K-major int8 operand at `addr` (a 1024-byte-aligned
// box plus a k32 step's 32-byte offsets).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

}  // namespace i8

// Defined in matmul_wgmma.cu: a uint8 tensor map with 128-byte swizzle
// over a rows x cols row-major int8 matrix with leading dimension ld
// (bytes), boxes of box_cols x box_rows, zeros outside the matrix.
bool tensor_map_i8(CUtensorMap* map, const void* p, int rows, int cols,
                   int ld, int box_cols, int box_rows);

}  // namespace vit
