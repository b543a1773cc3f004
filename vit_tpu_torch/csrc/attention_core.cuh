// The attention core as a device routine: masked softmax attention for one
// (image, head, 64-query tile), reading q, k and v straight from a packed
// (B*S, 3D) [q|k|v] buffer (head h at columns h*d of each third -- the
// layout vit_tpu/ops/pallas/block.py:_attn_core slices) and writing the
// context into a (B*S, D) buffer at the head's columns. K4's attention
// kernel (attention.cu) runs one tile a block; K9 (encoder_stack.cu) walks
// the tiles of its attention phase with it.
//
// Per query row, with _attn_core's rounding points:
//   s = (q . k) * scale in fp32, keys at index >= seq_len set to -inf;
//   p = exp(s - max), l = sum(p), both fp32;
//   ctx = (p rounded to the tensor's type) @ v in fp32, then / l;
//   ctx is stored in the tensor's type.
// The max is the row max over all keys, as in _encoder_stack_kernel
// (block.py:1953-1968), so K9 keeps that kernel's softmax exactly.
//
// A 64-row query tile keeps the fp32 scores (64 x S) and the head's K, V
// and Q in shared memory: 113 KB at S=208, d=64 in bf16, 173 KB in fp32.
// The math is plain FFMA over shared memory.

#pragma once

#include <math.h>

#include "common.cuh"

namespace vit {

constexpr int kAttnQT = 64;  // query rows a tile
constexpr int kAttnThreads = 256;

// K rows are padded by one 4-byte word so that threads reading consecutive
// keys hit consecutive banks.
template <typename T>
__host__ __device__ inline int attn_ldk(int dh) {
  return dh + 4 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ inline size_t attn_t_bytes(int s, int dh) {
  const size_t elems = static_cast<size_t>(s) * attn_ldk<T>(dh) +
                       static_cast<size_t>(s) * dh +
                       static_cast<size_t>(kAttnQT) * dh;
  return (elems * sizeof(T) + 15) / 16 * 16;
}

// Dynamic shared memory of one tile (vit_tpu_torch/ops/cuda/block.py:
// attention_smem_bytes computes the same).
template <typename T>
inline size_t attention_smem(int s, int dh) {
  return attn_t_bytes<T>(s, dh) +
         (static_cast<size_t>(kAttnQT) * s + kAttnQT) * sizeof(float);
}

// Query rows q0 .. q0+63 of head h of image img; s is the padded sequence,
// d the model width, dh the head width. Called by all kAttnThreads threads
// of the block; it synchronises the block and uses attention_smem<T>(s, dh)
// bytes of `smem`.
template <typename T>
__device__ __forceinline__ void attention_tile(const T* qkv, T* out, int s,
                                               int d, int dh, float scale,
                                               int seq_len, int img, int h,
                                               int q0, unsigned char* smem) {
  const int ldk = attn_ldk<T>(dh);
  T* ks = reinterpret_cast<T*>(smem);         // s x ldk
  T* vs = ks + static_cast<size_t>(s) * ldk;  // s x dh
  T* qs = vs + static_cast<size_t>(s) * dh;   // kAttnQT x dh
  float* sc = reinterpret_cast<float*>(smem + attn_t_bytes<T>(s, dh));
  float* lsum = sc + static_cast<size_t>(kAttnQT) * s;

  const size_t ld = 3 * static_cast<size_t>(d);
  const T* base = qkv + static_cast<size_t>(img) * s * ld +
                  static_cast<size_t>(h) * dh;

  __syncthreads();  // the previous tile's readers of smem are done
  for (int e = threadIdx.x; e < s * dh; e += kAttnThreads) {
    const int j = e / dh, c = e % dh;
    ks[j * ldk + c] = base[j * ld + d + c];
    vs[e] = base[j * ld + 2 * d + c];
  }
  for (int e = threadIdx.x; e < kAttnQT * dh; e += kAttnThreads) {
    const int i = e / dh, c = e % dh;
    qs[e] = q0 + i < s ? base[(q0 + i) * ld + c] : from_f32<T>(0.f);
  }
  __syncthreads();

  // Scores, fp32, masked keys at -inf.
  for (int e = threadIdx.x; e < kAttnQT * s; e += kAttnThreads) {
    const int i = e / s, j = e % s;
    float v = -INFINITY;
    if (j < seq_len) {
      const T* qi = qs + i * dh;
      const T* kj = ks + j * ldk;
      float acc = 0.f;
      for (int c = 0; c < dh; ++c) acc = fmaf(to_f32(qi[c]), to_f32(kj[c]), acc);
      v = acc * scale;
    }
    sc[e] = v;
  }
  __syncthreads();

  // Softmax numerators, one warp a row: p = exp(s - max) rounded to T in
  // place, l = sum of the unrounded p.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kAttnQT; i += kAttnThreads / 32) {
    float* row = sc + static_cast<size_t>(i) * s;
    float mx = -INFINITY;
    for (int j = lane; j < s; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < s; j += 32) {
      const float p = expf(row[j] - mx);
      sum += p;
      row[j] = to_f32(from_f32<T>(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) lsum[i] = sum;
  }
  __syncthreads();

  // Context: (p @ v) / l; masked keys have p == 0 and are skipped.
  for (int e = threadIdx.x; e < kAttnQT * dh; e += kAttnThreads) {
    const int i = e / dh, c = e % dh;
    if (q0 + i >= s) continue;
    const float* p = sc + static_cast<size_t>(i) * s;
    float acc = 0.f;
    for (int j = 0; j < seq_len; ++j) acc = fmaf(p[j], to_f32(vs[j * dh + c]), acc);
    out[(static_cast<size_t>(img) * s + q0 + i) * d +
        static_cast<size_t>(h) * dh + c] = from_f32<T>(acc / lsum[i]);
  }
}

}  // namespace vit
