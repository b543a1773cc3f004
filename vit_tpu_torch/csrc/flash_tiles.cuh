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

// K7's launch arguments (flash_attention.cu; its fp32 kernels,
// flash_attention_tf32.cu).
struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  FaStrides sq, sk, sv, so;
  int heads, s, seq_len;
  float scale;
  bool vec;  // q, k and v rows may be copied in 16-byte chunks
};

// K7's fp32 form at head width hd over bh (image, head) pairs
// (flash_attention_tf32.cu).
cudaError_t launch_flash_f32(const FaArgs& a, int bh, int hd,
                             cudaStream_t st);

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, FaStrides st,
                                             int b, int h) {
  return static_cast<const T*>(p) + b * st.b + h * st.h;
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
