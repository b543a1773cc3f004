// What the flash-attention kernels share: K7 (flash_attention.cu) and its
// backward K13 (flash_attention_bwd.cu). Operands are (B, H, S, d) tensors
// read and written through explicit element strides with d contiguous, in
// tiles of 64 rows; in bf16 both stage them with cp.async and run their
// products on mma.sync fragments (mma_frag.cuh).

#pragma once

#include <math.h>

#include "common.cuh"
#include "mma_frag.cuh"

namespace vit {

constexpr int kFaBQ = 64;  // query rows a block
constexpr int kFaBK = 64;  // keys a tile
constexpr int kFaMaxHd = 128;

// Element strides of one (B, H, S, d) operand; d is contiguous.
struct FaStrides {
  long long b, h, s;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, FaStrides st,
                                             int b, int h) {
  return static_cast<const T*>(p) + b * st.b + h * st.h;
}

// Online-softmax update of one score row of kFaBK values held by a warp
// (lane owns columns lane and lane + 32 of `row`): masks keys >= seq_len,
// updates m and l in place, and returns the row's alpha; writes p rounded
// to P into prow. Every lane returns the same alpha.
template <typename P>
__device__ __forceinline__ float softmax_row(const float* row, P* prow,
                                             int k0, int seq_len, float scale,
                                             float* m, float* l, int lane) {
  float s0 = row[lane] * scale, s1 = row[lane + 32] * scale;
  if (k0 + lane >= seq_len) s0 = -INFINITY;
  if (k0 + lane + 32 >= seq_len) s1 = -INFINITY;
  const float m_old = *m;
  const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
  // m_new is -inf only while every key so far is masked; exp(-inf - -inf)
  // would be NaN, so such a row subtracts 0 and gets p = alpha = 0.
  const float base = m_new == -INFINITY ? 0.f : m_new;
  const float alpha = expf(m_old - base);
  const float p0 = expf(s0 - base), p1 = expf(s1 - base);
  const float sum = warp_sum(p0 + p1);
  prow[lane] = from_f32<P>(p0);
  prow[lane + 32] = from_f32<P>(p1);
  __syncwarp();
  if (lane == 0) {
    *m = m_new;
    *l = *l * alpha + sum;
  }
  return alpha;
}

// Rows [r0, r0 + 64) of a (S, HD) bf16 matrix (row stride ld) into a tile
// of row stride HD + 8 (the 16-byte pad keeps ldmatrix conflict-free);
// rows at or past s zero. vec: cp.async, to be committed and waited for by
// the caller; otherwise element copies.
template <int HD>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long ld, int r0, int s,
                                           bool vec) {
  stage_rows(dst, HD + 8, src + r0 * ld, ld, kFaBQ, s - r0, HD, HD, vec);
}

// v[r] = op over the four lanes of a quad, the lanes holding one row of a
// C fragment.
template <typename F>
__device__ __forceinline__ void quad_reduce(float (&v)[2], F op) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      v[r] = op(v[r], __shfl_xor_sync(0xffffffffu, v[r], m));
}

// c (16 x N) += a (a 16 x 16 A fragment) b[k0 .. k0+15, 0 .. N), b a
// row-major tile of stride ld read through ldmatrix.trans.
template <int N>
__device__ __forceinline__ void mma_ab(float (&c)[N / 8][4],
                                       const uint32_t (&a)[4], const bf16* b,
                                       int k0, int ld, int lane) {
#pragma unroll
  for (int n = 0; n < N; n += 16) {
    uint32_t bf[4];
    ldmatrix_b_rowmajor(bf, b, ld, k0, n, lane);
    mma_bf16(c[n / 8], a, bf[0], bf[1]);
    mma_bf16(c[n / 8 + 1], a, bf[2], bf[3]);
  }
}

inline bool aligned16_ptr(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

inline bool aligned16_strides(const FaStrides& s, int itemsize) {
  return (s.b * itemsize) % 16 == 0 && (s.h * itemsize) % 16 == 0 &&
         (s.s * itemsize) % 16 == 0;
}

}  // namespace vit
