// What the flash-attention kernels share: K7 (flash_attention.cu) and its
// backward K13 (flash_attention_bwd.cu). Operands are (B, H, S, d) tensors
// read and written through explicit element strides with d contiguous, in
// tiles of 64 rows.

#pragma once

#include <math.h>

#include "common.cuh"

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

// Copy rows [r0, r0 + 64) of a (S, HD) bf16 matrix with row stride ld into
// shared memory (row stride ldd); rows at or past s are zero.
template <int HD>
__device__ __forceinline__ void load_rows_bf16(bf16* __restrict__ dst,
                                               int ldd,
                                               const bf16* __restrict__ src,
                                               long long ld, int r0, int s,
                                               bool vec) {
  constexpr int kRowChunks = HD / 8;
  for (int ch = threadIdx.x; ch < kFaBQ * kRowChunks; ch += blockDim.x) {
    const int r = ch / kRowChunks, c = (ch % kRowChunks) * 8;
    bf16* d = dst + r * ldd + c;
    const int gr = r0 + r;
    if (gr < s) {
      const bf16* p = src + gr * ld + c;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(p);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = p[e];
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
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
