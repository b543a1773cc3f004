// bf16 tensor-core fragments on Hopper through mma.sync: thin wrappers over
// inline PTX (mma.sync, ldmatrix, cp.async) and the fragment and staging
// routines built on them, which K4's bf16 attention core
// (attention_mma.cuh) and K13's bf16 backward (flash_attention_bwd.cu)
// share.
//
// One warp computes D (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16)
// with mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. With
// g = lane / 4 and t = lane % 4, a lane holds:
//   A: a[0] = A(g, 2t..2t+1)      a[1] = A(g+8, 2t..2t+1)
//      a[2] = A(g, 2t+8..2t+9)    a[3] = A(g+8, 2t+8..2t+9)
//   B: b[0] = B(2t..2t+1, g)      b[1] = B(2t+8..2t+9, g)
//   C: c[0], c[1] = C(g, 2t), C(g, 2t+1)
//      c[2], c[3] = C(g+8, 2t), C(g+8, 2t+1)
// each bf16 pair in one 32-bit register, the lower column (or row of B) in
// the low half. So the C fragments of two neighbouring 16 x 8 tiles, packed
// to bf16 pairs, are the A fragment of their 16 x 16 product operand as
// they stand (FlashAttention-2's reuse of p in registers): a[0], a[1] from
// the first tile's (c[0], c[1]) and (c[2], c[3]), a[2], a[3] from the
// second's.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices from shared memory, lanes
// 8i..8i+7 giving the row addresses of matrix i; lane l receives r[i] =
// row l/4, elements 2(l%4)..+1 of matrix i, or with .trans the transposed
// matrix's. B of a K-major (n rows, k contiguous) tile is ldmatrix as it
// stands; B of a row-major (k rows, n contiguous) tile is ldmatrix.trans.
// Rows padded to an odd number of 16-byte units keep the eight rows of a
// matrix on distinct bank groups: no conflicts.
//
// Why mma.sync and not wgmma: the products these kernels run are a head's,
// K = 64 or 80 and N <= 208 per (image, head), 64 query rows a block. At
// B/16 bs=32 K4's core is bytes-bound on this card (0.0122 ms for its
// inputs and output at 3.35 TB/s, against about 0.005 ms of products at
// 989 TFLOP/s), and mma.sync's share of the tensor-core peak is enough to
// reach that line; it needs no warpgroup, no descriptors and no TMA.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vit {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b on the tensor cores: a 16 x 16 A fragment, the two registers of
// a 16 x 8 B fragment, a 16 x 8 fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; p is this lane's row address
// (16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of the 16 x 16 tile at (r0, c0) of a row-major bf16 tile
// in shared memory with row stride ld (elements): lanes 0-15 address rows
// r0..r0+15 at column c0, lanes 16-31 the same rows at c0 + 8.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4],
                                           const __nv_bfloat16* s, int ld,
                                           int r0, int c0, int lane) {
  ldmatrix_x4(a, s + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3));
}

// The B fragments of two neighbouring 8-column tiles: B(k, n) = S(n0 + n,
// k0 + k) of a K-major tile S (n rows, k contiguous; a key tile for q k^T).
// b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_b_kmajor(uint32_t (&b)[4],
                                                  const __nv_bfloat16* s,
                                                  int ld, int n0, int k0,
                                                  int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     (((lane >> 3) & 1) << 3));
}

// The B fragments of two neighbouring 8-column tiles: B(k, n) = S(k0 + k,
// n0 + n) of a row-major tile S (k rows, n contiguous; v for p v), through
// ldmatrix.trans. b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..+15.
__device__ __forceinline__ void ldmatrix_b_rowmajor(uint32_t (&b)[4],
                                                    const __nv_bfloat16* s,
                                                    int ld, int k0, int n0,
                                                    int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                           n0 + ((lane >> 4) << 3));
}

// Two fp32 rounded to bf16 (round to nearest even) in one register, lo in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16 x 8 pair of C tiles c0 (columns 0-7) and c1
// (columns 8-15), rounded to bf16 where they stand.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// The A fragment of rows 0..15, columns c0..c0+15 of a row-major bf16
// matrix in device memory (row stride ld elements), read element by
// element: rows >= nrows and columns >= ncols are zero.
__device__ __forceinline__ void load_a_global(uint32_t (&a)[4],
                                              const __nv_bfloat16* src,
                                              size_t ld, int nrows, int c0,
                                              int ncols, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (lane >> 2) + 8 * (i & 1);
    const int c = c0 + 2 * (lane & 3) + 8 * (i >> 1);
    float lo = 0.f, hi = 0.f;
    if (r < nrows) {
      const __nv_bfloat16* p = src + r * ld + c;
      if (c < ncols) lo = __bfloat162float(p[0]);
      if (c + 1 < ncols) hi = __bfloat162float(p[1]);
    }
    a[i] = pack_bf16x2(lo, hi);
  }
}

// 16 bytes from device to shared memory without passing through registers
// (cp.async.cg: cached in L2 only); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(src));
}

// Rows [0, rows) of a bf16 tile in shared memory (row stride ld, 16-byte
// aligned rows), staged by the block's threads: row r < nvalid is src row
// r (row stride ldg) with its columns >= cols zero, up to padded columns;
// every row >= nvalid is zero. vec: cols and the source rows allow 16-byte
// copies (cp.async, to be committed and waited for by the caller);
// otherwise element copies.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           size_t ldg, int rows, int nvalid,
                                           int cols, int padded, bool vec) {
  const int chunks = padded / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e % chunks) * 8;
    __nv_bfloat16* dp = dst + r * ld + c;
    if (r < nvalid && c < cols) {
      const __nv_bfloat16* sp = src + r * ldg + c;
      if (vec) {
        cp_async16(dp, sp);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dp[i] = c + i < cols ? sp[i] : __float2bfloat16_rn(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(dp) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Close the group of this thread's cp.async copies issued since the last
// commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight;
// a __syncthreads() after it makes every thread's copies visible.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace vit
